"""Chameleon-34B backbone [arXiv:2405.09818; unverified].

Early-fusion VLM: image content arrives as VQ-VAE codebook tokens inside the
65536-entry vocabulary, so the backbone is a pure decoder LM; the modality
frontend (VQ tokenizer) is a stub per the assignment. Chameleon-34B uses
qk-norm for stability.
"""
from repro_torch.models.config import LayerGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    groups=(LayerGroup(("attn",), 48),),
    qk_norm=True,
    ffn_kind="swiglu",
    tie_embeddings=False,
    rope_theta=10_000.0,
    frontend="patch",
))
