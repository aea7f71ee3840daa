"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf].

Attention-free: data-dependent-decay WKV recurrence + squared-ReLU channel
mixing. O(1) state per layer, so this arch serves the long_500k cell.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    d_model=2560,
    n_heads=40,            # 2560 / 64 WKV heads
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    groups=(LayerGroup(("rwkv",), 32),),
    rwkv_head_dim=64,
    ffn_kind="swiglu",     # unused by rwkv blocks (cmix is built in)
    tie_embeddings=False,
))
