"""Whisper-tiny [arXiv:2212.04356; unverified].

Encoder-decoder; the conv frontend is a STUB: input_specs() provides
precomputed 1500-frame embeddings [B, 1500, 384] (per the assignment the
backbone only is modeled). 4 encoder + 4 decoder layers, GELU MLPs.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    groups=(LayerGroup(("enc",), 4), LayerGroup(("dec",), 4)),
    ffn_kind="gelu",
    enc_seq=1500,
    tie_embeddings=True,
    frontend="audio",
))
