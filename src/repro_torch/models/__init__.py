"""Model substrate of the port: configs, backbone, attention."""
from .backbone import Backbone
from .config import (ARCH_NAMES, LayerGroup, ModelConfig, get_config, reduced,
                     register)
from .partition import IDENTITY_PLAN, PartitionPlan

__all__ = ["Backbone", "ARCH_NAMES", "LayerGroup", "ModelConfig",
           "get_config", "reduced", "register", "IDENTITY_PLAN",
           "PartitionPlan"]
