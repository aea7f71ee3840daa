from .pipeline import DataConfig, Pipeline, make_batch
__all__ = ["DataConfig", "Pipeline", "make_batch"]
