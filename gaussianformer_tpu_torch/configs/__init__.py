from .nuscenes import (MANUAL_CLASS_WEIGHT, DataConfig, GaussianFormerConfig,
                       OptimConfig, get_config, list_configs)

__all__ = ["MANUAL_CLASS_WEIGHT", "DataConfig", "GaussianFormerConfig",
           "OptimConfig", "get_config", "list_configs"]
