"""Mixtral 8x22B [arXiv:2401.04088; hf].

8-expert top-2 MoE FFN, sliding-window attention (4096), GQA 48/8. The SWA
window bounds the decode KV cache, so this arch runs long_500k.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    groups=(LayerGroup(("local",), 56),),
    attn_window=4096,
    ffn_kind="moe",
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
))
