"""The input pipeline (gaussianformer_tpu/data/): the nuScenes dataset and
its transforms, the synthetic data, the sampler and the loader."""
from .dataset import NuScenesDataset
from .loader import DataLoader, ShardedSampler
from .synthetic import SyntheticOccDataset

__all__ = ["DataLoader", "NuScenesDataset", "ShardedSampler",
           "SyntheticOccDataset"]
