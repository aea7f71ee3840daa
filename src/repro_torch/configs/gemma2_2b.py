"""Gemma-2 2B [arXiv:2408.00118; hf].

Local(4096-window)/global alternating attention, GeGLU, logit soft-capping
(attn 50.0, final 30.0), sqrt(d) embedding scaling, tied embeddings.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    groups=(LayerGroup(("local", "attn"), 13),),   # 26 layers alternating
    attn_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    ffn_kind="geglu",
    tie_embeddings=True,
    embed_scale=True,
))
