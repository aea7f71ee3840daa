"""Model substrate of the port: configs, backbone, attention."""
from .backbone import Backbone
from .config import (ARCH_NAMES, SHAPES, LayerGroup, ModelConfig, ShapeConfig,
                     all_configs, get_config, reduced, register)
from .partition import IDENTITY_PLAN, PartitionPlan

__all__ = ["Backbone", "ARCH_NAMES", "SHAPES", "LayerGroup", "ModelConfig",
           "ShapeConfig", "all_configs", "get_config", "reduced", "register",
           "IDENTITY_PLAN", "PartitionPlan"]
