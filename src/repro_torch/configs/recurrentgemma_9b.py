"""RecurrentGemma-9B [arXiv:2402.19427; unverified].

Griffin hybrid: RG-LRU recurrent blocks and local (2048-window) attention in
a 2:1 pattern; 38 layers = 12×(rec,rec,local) + 2 rec. Bounded window +
O(1) recurrent state -> runs long_500k.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    groups=(LayerGroup(("rec", "rec", "local"), 12),
            LayerGroup(("rec",), 2)),
    attn_window=2048,
    ffn_kind="geglu",
    rglru_width=4096,
    conv1d_width=4,
    tie_embeddings=True,
    embed_scale=True,
))
