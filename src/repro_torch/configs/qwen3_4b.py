"""Qwen3-4B [hf:Qwen/Qwen3-8B family; hf]. qk_norm, GQA 32/8."""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151_936,
    groups=(LayerGroup(("attn",), 36),),
    qk_norm=True,
    ffn_kind="swiglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
