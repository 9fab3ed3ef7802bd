"""Sampler and loader (gaussianformer_tpu/data/loader.py, reference
dataset/__init__.py:15-79 and dataset/sampler.py:12-137): a deterministic
shuffle per epoch, per-process shards, the ``set_last_iter`` fast-forward
of a mid-epoch resume, and batches of tensors from
``torch.utils.data.DataLoader``.

Worker processes each get a copy of the dataset, and with it a copy of its
``RandomState``: every worker would draw the same augmentations. So a
worker reseeds the dataset's generator from (dataset seed, epoch, worker
id) at the first sample of each epoch it loads. The epoch travels with
each index from the main process, where the sampler lives, so persistent
workers follow ``set_epoch``. With ``num_workers=0`` nothing is reseeded
and the batches equal the JAX package's loader's, draws included."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader as TorchDataLoader
from torch.utils.data import get_worker_info


class ShardedSampler:
    def __init__(self, num_samples: int, shard_id: int = 0,
                 num_shards: int = 1, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.num_samples = num_samples
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.last_iter = 0
        if drop_last:
            self.shard_len = num_samples // num_shards
        else:
            self.shard_len = -(-num_samples // num_shards)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_last_iter(self, last_iter: int):
        """Skip the first ``last_iter`` samples of the next pass only."""
        self.last_iter = last_iter

    def __len__(self):
        return self.shard_len

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        # pad to a multiple of num_shards by wrapping around, as torch does
        total = self.shard_len * self.num_shards
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        shard = order[self.shard_id:total:self.num_shards]
        start = self.last_iter
        self.last_iter = 0
        return iter(shard[start:].tolist())


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """Stack each key's arrays into one tensor ([B, ...])."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in samples[0]}


class _EpochBatches:
    """The loader's batches of (epoch, index) keys, for torch's loader."""

    def __init__(self, loader: "DataLoader"):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        epoch = self.loader.sampler.epoch
        for batch in self.loader.batches():
            yield [(epoch, i) for i in batch]


class _Reseeding(torch.utils.data.Dataset):
    """The dataset behind (epoch, index) keys. In a worker process, the
    first key of each epoch gives the dataset's ``rng`` (where it has one)
    a new ``RandomState`` from (dataset seed, epoch, worker id)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.epoch = None

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = key
        worker = get_worker_info()
        if (worker is not None and epoch != self.epoch
                and hasattr(self.dataset, "rng")):
            self.epoch = epoch
            seq = np.random.SeedSequence([self.dataset.seed, epoch,
                                          worker.id])
            self.dataset.rng = np.random.RandomState(seq.generate_state(1))
        return self.dataset[index]


class DataLoader:
    """Batches of ``batch_size`` in the sampler's order (the last, short
    one dropped with ``drop_last``), collated to tensors. ``num_workers``
    > 0 loads in that many persistent worker processes (started with
    ``spawn``), two batches ahead each; ``pin_memory`` for a CUDA
    consumer. :meth:`close` stops the workers."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[ShardedSampler] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 0,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed)
        self.drop_last = drop_last
        self.num_workers = num_workers
        workers = dict(multiprocessing_context="spawn",
                       persistent_workers=True) if num_workers > 0 else {}
        self._torch = TorchDataLoader(
            _Reseeding(dataset), batch_sampler=_EpochBatches(self),
            num_workers=num_workers, collate_fn=collate,
            pin_memory=pin_memory, **workers)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def batches(self) -> List[List[int]]:
        """This pass's batches of sample indices (consumes the sampler's
        fast-forward)."""
        idxs = list(self.sampler)
        bs = self.batch_size
        out = [idxs[i:i + bs] for i in range(0, len(idxs), bs)]
        if self.drop_last:
            out = [b for b in out if len(b) == bs]
        return out

    def __iter__(self):
        return iter(self._torch)

    def close(self):
        """Stop the worker processes (a later pass starts new ones), as
        torch's loader does when its iterator is collected."""
        it = self._torch._iterator
        if it is not None:
            it._shutdown_workers()
            self._torch._iterator = None
