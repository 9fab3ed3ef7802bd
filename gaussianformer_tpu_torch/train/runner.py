"""Training and evaluation runner (gaussianformer_tpu/train/runner.py,
reference train.py / eval.py): the host loop around
:func:`train.step.train_step` that feeds batches, draws the supervised
layers, logs, checkpoints and resumes, and the eval loop with its counts
read one batch late.

The train state of the JAX package (``train/train_state.py``) is here the
model and its optimizer: a checkpoint holds the model's ``state_dict``
(BN statistics included), the optimizer's, the gradient accumulation's
where there is one, and the epoch and iteration counters.

Several processes (torchrun, ``parallel/distributed.py``): each trains
on its shard of the samples, on ``cuda:LOCAL_RANK``, with the model in
torch's DistributedDataParallel, which averages the ranks' gradients of
their own losses (the upstream reference's DDP; the JAX package's sharded
step differentiates one loss over the global batch instead); with
gradient accumulation the micro-steps run under ``no_sync`` and the
accumulated mean is averaged once. The clipping reads the averaged
gradients. Only rank 0 logs, writes ``metrics.jsonl`` and checkpoints;
every rank resumes; the eval counts are summed over the ranks."""
from __future__ import annotations

import inspect
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import GaussianFormerConfig
from ..data import NuScenesDataset, SyntheticOccDataset
from ..device import resolve_device
from ..metrics import MeanIoU, compute_iou
from ..models.segmentor import build_segmentor
from ..parallel import (all_reduce_sum_host, barrier, init_distributed,
                        is_main_process, local_rank)
from ..utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                save_checkpoint)
from .optim import GradientAccumulation, build_optimizer
from .step import build_loss, train_step

logger = logging.getLogger("gaussianformer_tpu_torch")

#: iterations between the checkpoints of a mid-epoch resume
#: (``iter_resume``, reference --iter-resume, train.py:253-267)
ITER_CKPT_EVERY = 50


def setup_logging(work_dir: Optional[str] = None):
    """INFO to stderr and, with ``work_dir``, to ``<work_dir>/train.log``."""
    handlers = [logging.StreamHandler()]
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(work_dir, "train.log")))
    logging.basicConfig(level=logging.INFO, handlers=handlers,
                        format="%(asctime)s %(levelname)s %(message)s",
                        force=True)


def build_dataset(cfg: GaussianFormerConfig, split: str, *,
                  synthetic: bool = False, num_samples: int = 2,
                  data_root: str = "data/nuscenes",
                  anno_root: str = "data/nuscenes_cam",
                  occ_path: str = "data/surroundocc/samples", seed: int = 0):
    """The CLIs' dataset of ``split`` ("train" or "val"): synthetic
    (``num_samples`` samples at the config's image size and grid; the val
    set from seed 1) or nuScenes from the infos pkl under ``anno_root``,
    augmented only in training."""
    if synthetic:
        return SyntheticOccDataset(
            num_samples=num_samples, num_cams=cfg.num_cams,
            image_size=cfg.input_size, grid=cfg.occ_resolution,
            pc_range=cfg.pc_range, seed=seed if split == "train" else 1)
    aug = dict(H=900, W=1600, final_dim=cfg.input_size,
               resize_lim=cfg.data.resize_lim, rot_lim=cfg.data.rot_lim,
               rand_flip=cfg.data.rand_flip)
    return NuScenesDataset(
        data_root, f"{anno_root}/nuscenes_infos_{split}_sweeps_occ.pkl",
        occ_path, data_aug_conf=aug, phase=split,
        img_norm=dict(mean=cfg.data.img_mean, std=cfg.data.img_std),
        seed=seed)


class Trainer:
    """Fit and evaluate one model on ``device`` (CUDA unless the caller asks
    for the CPU). The model starts from the seeded random weights of
    ``build_segmentor(cfg, seed=seed)``."""

    def __init__(self, cfg: GaussianFormerConfig, train_loader, val_loader,
                 work_dir: str, *, seed: int = 0, print_freq: int = 50,
                 grad_accumulation: int = 1, iter_resume: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.work_dir = work_dir
        self.seed = seed
        self.print_freq = print_freq
        self.grad_accumulation = grad_accumulation
        self.iter_resume = iter_resume
        self.device = resolve_device(device)
        self.rank, self.world_size = init_distributed(self.device)
        if self.device.type == "cuda" and torch.distributed.is_initialized():
            self.device = torch.device("cuda", local_rank())
        self.model = build_segmentor(cfg, device=self.device, seed=seed)
        #: the model the train step runs: DistributedDataParallel's
        #: wrapper in a process group, else the model itself
        self.train_model = self.model
        self.loss_fn = build_loss(cfg)
        self.optimizer = None
        self.schedule = None
        self.accumulation = None
        self.epoch = 0
        self.global_iter = 0
        # batches of the current epoch that a resume skipped
        self._skipped = 0
        #: the counts of the last :meth:`evaluate`
        self.last_counts: Optional[np.ndarray] = None

    # -------------------------------------------------------------- setup
    def init_state(self, inference_only: bool = False):
        """The optimizer over the trained parameters (the frozen prefixes
        of ``train.optim.frozen_prefixes`` left out) and its schedule over
        ``len(train_loader) * max_epochs`` steps; ``inference_only``: none,
        the weights alone (eval)."""
        if inference_only:
            self.optimizer = None
            self.schedule = lambda _: 0.0
            return
        total_steps = len(self.train_loader) * self.cfg.optim.max_epochs
        self.optimizer, self.schedule = build_optimizer(
            self.model, self.cfg, total_steps)
        self.accumulation = (GradientAccumulation(self.grad_accumulation)
                             if self.grad_accumulation > 1 else None)
        if torch.distributed.is_initialized():
            self.train_model = self._wrap_ddp()

    def _wrap_ddp(self):
        """The model in DistributedDataParallel. Its buffers (BN statistics,
        the modules' constants) never change in a step: none is broadcast.
        Every parameter gets a gradient in a step, frozen ones included,
        unless the supervised layers leave out the last refine layer (a
        ``fixed_*`` choice without it): only then does DDP search the graph
        for unused parameters."""
        from torch.nn.parallel import DistributedDataParallel
        alt = self.cfg.apply_loss_type
        last = str(self.cfg.num_decoder - 1)
        unused = alt.startswith("fixed") and last not in alt.split("_")[1:]
        cuda = self.device.type == "cuda"
        # newer torch names the switch forward_sync_buffers (it still syncs
        # them once at construction, which the seeded ranks agree on)
        no_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers"
                   in inspect.signature(DistributedDataParallel).parameters
                   else {"broadcast_buffers": False})
        logger.info("DistributedDataParallel: rank %d of %d, backend %s, "
                    "find_unused_parameters=%s", self.rank, self.world_size,
                    torch.distributed.get_backend(), unused)
        return DistributedDataParallel(
            self.model, device_ids=[self.device.index] if cuda else None,
            find_unused_parameters=unused, **no_sync)

    def _draw_loss_layers(self):
        """The supervised layers of a ``random_k`` config with k > 1
        (reference gaussian_head.py:133-137: k - 1 distinct picks from the
        first num_decoder - 1 layers, plus the last), drawn from (seed,
        global_iter) so a resumed run draws the same; None where the head
        chooses by itself."""
        alt = self.cfg.apply_loss_type
        if not alt.startswith("random_"):
            return None
        k = int(alt.split("_")[1])
        if k <= 1:
            return None
        d = self.cfg.num_decoder
        if self.rank == 0:
            rs = np.random.RandomState(
                (self.seed * 1_000_003 + self.global_iter) % (2 ** 31 - 1))
        else:
            rs = np.random.RandomState(np.random.SeedSequence(
                [self.seed, self.global_iter, self.rank]).generate_state(1))
        extra = rs.choice(d - 1, k - 1, replace=False)
        return tuple(sorted(extra.tolist() + [d - 1]))

    def _step_generator(self) -> torch.Generator:
        return step_generator(self.seed, self.global_iter, self.rank,
                              self.device)

    def _to_device(self, batch: Dict[str, torch.Tensor]):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def load_torch_pretrained(self, backbone_path: Optional[str] = None,
                              lifter_init_path: Optional[str] = None):
        """Load reference PyTorch pretrains into the model by name (the
        port's module names are the reference's):

        - ``backbone_path`` (r101_dcn_fcos3d_pretrain.pth, reference
          load_from, train.py:156-167): ``img_backbone.*`` or
          ``backbone.*`` into ``img_backbone.*``, ``img_neck.*`` into
          ``img_neck.*``;
        - ``lifter_init_path`` (the GaussianLifterV2 initializer init.pth,
          gaussian_lifter_v2.py:109-117): its ``img_backbone.*`` and
          ``img_neck.*`` into ``lifter.initialize_backbone.*``; its
          ``anchor`` and ``instance_feature`` are dropped.

        A ``state_dict`` wrapper is unwrapped; tensors the model has no
        place for (``num_batches_tracked``, detection heads) are skipped;
        a shape that differs raises. The port's names are the reference's,
        so no tensor needs a mapping of its own (the FFN's ``pre_norm``
        included)."""
        if backbone_path:
            sd = _read_state_dict(backbone_path)
            prefix = ("img_backbone." if any(
                k.startswith("img_backbone.") for k in sd) else "backbone.")
            picked = {"img_backbone." + k[len(prefix):]: v
                      for k, v in sd.items() if k.startswith(prefix)}
            picked.update({k: v for k, v in sd.items()
                           if k.startswith("img_neck.")})
            self._load_named(picked, backbone_path)
        if lifter_init_path:
            sd = _read_state_dict(lifter_init_path)
            picked = {"lifter.initialize_backbone." + k: v
                      for k, v in sd.items()
                      if k.startswith(("img_backbone.", "img_neck."))}
            self._load_named(picked, lifter_init_path)

    def _load_named(self, tensors: Dict[str, torch.Tensor], path: str):
        own = self.model.state_dict()
        skipped = sorted(k for k in tensors if k not in own)
        loaded = [k for k in tensors if k in own]
        if not loaded:
            raise ValueError(f"{path}: none of its tensors names a "
                             f"parameter or statistic of the model")
        with torch.no_grad():
            for k in loaded:
                if tuple(tensors[k].shape) != tuple(own[k].shape):
                    raise ValueError(
                        f"{path}: {k} has shape {tuple(tensors[k].shape)}, "
                        f"the model's is {tuple(own[k].shape)}")
                own[k].copy_(tensors[k])
        logger.info("loaded %d tensors from %s; skipped %d the model has no "
                    "place for%s", len(loaded), path, len(skipped),
                    f" (first: {skipped[0]})" if skipped else "")

    # ------------------------------------------------------------- resume
    def try_resume(self) -> bool:
        """Restore the newest checkpoint of the work dir, if any: the model,
        the optimizer (when built), the accumulation, the counters and, for
        a checkpoint taken mid-epoch, the sampler's fast-forward."""
        path = latest_checkpoint(self.work_dir)
        if path is None:
            return False
        state = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        if self.optimizer is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        if self.accumulation is not None:
            self.accumulation.load_state_dict(state["grad_accumulation"])
        self.epoch = int(state["epoch"])
        self.global_iter = int(state["global_iter"])
        last_iter = int(state.get("last_iter", 0))
        if last_iter:
            # mid-epoch fast-forward (reference CustomDistributedSampler,
            # dataset/sampler.py:112-118)
            self.train_loader.sampler.set_last_iter(
                last_iter * self.train_loader.batch_size)
            self._skipped = last_iter
        logger.info("resumed from %s at epoch %d iter %d", path, self.epoch,
                    self.global_iter)
        return True

    def save(self, last_iter: int = 0):
        """Checkpoint at ``global_iter`` (rank 0 writes, the others wait
        for it); ``last_iter``: batches of the current epoch already taken
        (0 at an epoch's end)."""
        if is_main_process():
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.state_dict(),
                     "epoch": self.epoch, "global_iter": self.global_iter,
                     "last_iter": last_iter}
            if self.accumulation is not None:
                state["grad_accumulation"] = self.accumulation.state_dict()
            save_checkpoint(self.work_dir, self.global_iter, state)
        barrier()

    def _log_scalars(self, metrics, lr):
        """One JSON line per logging step in ``<work_dir>/metrics.jsonl``
        (in place of the reference's TensorBoard writer), rank 0's."""
        if not is_main_process():
            return
        rec = {"epoch": self.epoch, "iter": self.global_iter, "lr": lr,
               "time": time.time(), **metrics}
        os.makedirs(self.work_dir, exist_ok=True)
        with open(os.path.join(self.work_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -------------------------------------------------------------- train
    def fit(self):
        """Train to ``cfg.optim.max_epochs``: a checkpoint and, with a val
        loader, an evaluation after each epoch; with ``iter_resume`` also a
        checkpoint every ``ITER_CKPT_EVERY`` iterations."""
        if self.optimizer is None:
            self.init_state()
            self.try_resume()
        sampler = self.train_loader.sampler
        while self.epoch < self.cfg.optim.max_epochs:
            sampler.set_epoch(self.epoch)
            skipped, self._skipped = self._skipped, 0
            t_data = time.time()
            for i, batch in enumerate(self.train_loader):
                batch = self._to_device(batch)
                data_time = time.time() - t_data
                metrics = train_step(
                    self.train_model, self.optimizer, self.schedule, self.loss_fn,
                    batch, self._step_generator(), self._draw_loss_layers(),
                    self.accumulation)
                self.global_iter += 1
                if i % self.print_freq == 0:
                    metrics = {k: v.item() for k, v in metrics.items()}
                    lr = self.schedule(self.global_iter)
                    step_time = time.time() - t_data - data_time
                    logger.info(
                        "epoch %d iter %d loss %.4f grad %.2f lr %.2e "
                        "data %.2fs step %.2fs", self.epoch, skipped + i,
                        metrics["loss"], metrics["grad_norm"], lr, data_time,
                        step_time)
                    self._log_scalars({**metrics, "data_time": data_time,
                                       "step_time": step_time}, lr)
                if self.iter_resume and self.global_iter % ITER_CKPT_EVERY == 0:
                    self.save(last_iter=skipped + i + 1)
                t_data = time.time()
            self.epoch += 1
            self.save()
            if self.val_loader is not None:
                self.evaluate()

    # --------------------------------------------------------------- eval
    def evaluate(self) -> Tuple[float, float]:
        """(mIoU %, occupancy IoU %) over the val loader, under inference
        mode, the lifter drawing from a generator seeded with ``seed``. A
        batch's counts are queued on the device behind its forward and read
        after the next batch's forward is queued. In a process group each
        rank evaluates its shard and the counts are summed over the
        ranks."""
        miou = MeanIoU()
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pending = None
        with torch.inference_mode():
            for batch in self.val_loader:
                batch = self._to_device(batch)
                out = self.model(
                    batch["imgs"], batch["projection_mat"], batch["image_wh"],
                    batch["occ_xyz"], batch["occ_label"],
                    batch["occ_cam_mask"], generator=gen)
                counts = miou.counts_for(out["final_occ"],
                                         out["sampled_label"],
                                         out["occ_mask"])
                if pending is not None:
                    miou.add_counts(pending)
                pending = counts
            if pending is not None:
                miou.add_counts(pending)
        self.last_counts = all_reduce_sum_host(miou.counts)
        m, occ_iou, per_class = compute_iou(self.last_counts)
        logger.info("val mIoU %.2f%%  occ IoU %.2f%%", m, occ_iou)
        logger.info("val counts (seen, correct, predicted; per class, then "
                    "occupied), summed over %d process(es): %s",
                    self.world_size, json.dumps(self.last_counts.tolist()))
        for name, iou in zip(miou.label_str, per_class):
            logger.info("  %s: %.2f%%", name, iou * 100)
        return m, occ_iou


def step_generator(seed: int, global_iter: int, rank: int = 0,
                   device="cpu") -> torch.Generator:
    """A step's dropout and lifter draws, from (seed, global_iter), and the
    rank after rank 0: a resumed run draws what an uninterrupted one
    would, rank 0 what a single process would, each rank its own."""
    key = [seed, global_iter] + ([rank] if rank else [])
    seq = np.random.SeedSequence(key)
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1)[0]))


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors, unwrapped from a ``state_dict`` entry."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)
