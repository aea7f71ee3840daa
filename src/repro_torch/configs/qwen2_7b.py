"""Qwen2-7B [arXiv:2407.10671; hf].

GQA 28/4 with QKV bias, SwiGLU, 152k vocab. 28 query heads do not divide the
16-way TP axis: the PartitionPlan zero-pads to 32 (exactness tested).
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152_064,
    groups=(LayerGroup(("attn",), 28),),
    qkv_bias=True,
    ffn_kind="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
))
