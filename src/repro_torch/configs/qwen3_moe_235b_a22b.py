"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].

128 experts, top-8 routing, per-expert d_ff 1536, qk_norm, GQA 64/4.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151_936,
    groups=(LayerGroup(("attn",), 94),),
    qk_norm=True,
    ffn_kind="moe",
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
))
