"""One module per ported architecture; each registers its ModelConfig.

``repro_torch.models.config.get_config(name)`` lazily imports these.
"""
