from .nuscenes import (MANUAL_CLASS_WEIGHT, GaussianFormerConfig,
                       OptimConfig, get_config)

__all__ = ["MANUAL_CLASS_WEIGHT", "GaussianFormerConfig", "OptimConfig",
           "get_config"]
