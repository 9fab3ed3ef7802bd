from .nuscenes import GaussianFormerConfig, get_config

__all__ = ["GaussianFormerConfig", "get_config"]
