"""Phi-4-mini 3.8B [arXiv:2412.08905; hf].

RoPE (partial rotary 0.75), SwiGLU, GQA 24/8, 200k vocab.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    groups=(LayerGroup(("attn",), 32),),
    rotary_pct=0.75,
    ffn_kind="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
))
