"""The whole model in plain PyTorch, assembled from a configuration file's
``config``: towers, lifter, encoder, head, with the program's parameter
names; and the train step (losses, backward, global-norm clipping and
AdamW in the configuration's two learning-rate groups, with its warm-up
cosine schedule)."""
from __future__ import annotations

import math

import torch
from torch import nn

from .encoder import GaussianOccEncoder
from .head import GaussianHead
from .lifter import GaussianLifter, GaussianLifterV2
from .losses import occupancy_loss, pixel_distribution_loss
from .precision import REFERENCE, Precision
from .towers import FPN, ResNet


class Model(nn.Module):
    def __init__(self, c, prec: Precision = REFERENCE,
                 checkpoint: bool = False):
        super().__init__()
        self.c = c
        self.prec = prec
        self.img_backbone = ResNet(c["depth"], c["base_channels"],
                                   c["stage_with_dcn"], prec, checkpoint)
        self.img_neck = FPN(self.img_backbone.out_channels, c["embed_dims"],
                            prec=prec)
        self.lifter = (GaussianLifterV2(c, prec, checkpoint)
                       if c["version"] == 2 else GaussianLifter(c))
        self.encoder = GaussianOccEncoder(c, prec, checkpoint)
        self.head = GaussianHead(c, prec)

    def towers(self, imgs):
        """imgs [B, cams, H, W, 3] -> per level [B, cams, h, w, C]."""
        b, n = imgs.shape[:2]
        flat = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(flat))
        return [f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:4], -1)
                for f in feats]

    def losses(self, sample, xyz, rand):
        """The train step's forward and losses on ``sample``, with the
        anchors' positions ``xyz`` [B, num_anchor, 3] (GaussianFormer-2;
        None for v1) and dropout uniforms from ``rand``. Returns (loss,
        {term: value})."""
        c = self.c
        with self.prec.matmul():
            maps = self.towers(sample["imgs"])
            terms = {}
            b = sample["imgs"].shape[0]
            if c["version"] == 2:
                lf = self.lifter
                _, logits = lf.pixel_logits(sample["imgs"])
                origin, ray = lf.rays(sample["projection_mat"],
                                      sample["image_wh"], *logits.shape[2:4])
                gt = lf.pixel_gt(origin, ray, sample["occ_label"],
                                 sample["occ_cam_mask"])
                anchor, feat = lf.representation(xyz)
                terms["PixelDistributionLoss"] = pixel_distribution_loss(
                    logits, gt)
            else:
                anchor, feat = self.lifter.representation(b)
            preds = self.encoder(anchor, feat, maps,
                                 sample["projection_mat"],
                                 sample["image_wh"], rand)
            outs, _ = self.head(preds, sample["occ_xyz"], training=True)
            terms["OccupancyLoss"] = occupancy_loss(
                c, outs, sample["occ_label"], sample["occ_cam_mask"])
        return sum(terms.values()), terms


def state_shapes(c):
    """name -> shape of every parameter and BN statistic of the model."""
    with torch.device("meta"):
        m = Model(c)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


# the configurations' frozen parameters (reference backbone config:
# frozen_stages=1; freeze_lifter keeps random_anchors trained) and the
# backbone's learning-rate group
FROZEN = ("img_backbone.conv1.", "img_backbone.bn1.", "img_backbone.layer1.")
FROZEN_LIFTER = ("lifter.initialize_backbone.", "lifter.projection.",
                 "lifter.anchor", "lifter.instance_feature")
WARMUP_INIT = 1e-6


def schedule(o, total_steps):
    """Linear warm-up from 1e-6 to the lr over ``warmup_iters`` steps, then
    a cosine down to lr * min_lr_ratio at ``total_steps``."""
    decay = max(total_steps, o["warmup_iters"] + 1) - o["warmup_iters"]

    def lr(step):
        if step < o["warmup_iters"]:
            return WARMUP_INIT + (o["lr"] - WARMUP_INIT) * step \
                / o["warmup_iters"]
        t = min(step - o["warmup_iters"], decay)
        cos = 0.5 * (1 + math.cos(math.pi * t / decay))
        return o["lr"] * ((1 - o["min_lr_ratio"]) * cos + o["min_lr_ratio"])
    return lr


class TrainStep:
    """The reference's optimizer: AdamW (0.9, 0.999, eps 1e-8, the
    config's weight decay) over the trained parameters, the backbone's at
    ``backbone_lr_mult`` times the lr; the gradients of every parameter
    clipped together to ``grad_max_norm``."""

    def __init__(self, model: Model, total_steps: int):
        c = model.c
        o = c["optim"]
        frozen = FROZEN + (FROZEN_LIFTER if c["freeze_lifter"] else ())
        self.model = model
        self.trained = {k: p for k, p in model.named_parameters()
                        if not k.startswith(frozen)}
        self.mult = {k: (o["backbone_lr_mult"]
                         if k.startswith("img_backbone.") else 1.0)
                     for k in self.trained}
        groups = [{"params": [p for k, p in self.trained.items()
                              if self.mult[k] == m], "mult": m}
                  for m in (1.0, o["backbone_lr_mult"])]
        self.opt = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=o["weight_decay"],
                                     foreach=False)
        self.lr = schedule(o, total_steps)
        self.max_norm = o["grad_max_norm"]
        self.t = 0

    def __call__(self, sample, xyz, rand):
        """One step. Returns (loss, terms, grad norm before clipping,
        {name: clipped gradient})."""
        self.model.zero_grad(set_to_none=True)
        loss, terms = self.model.losses(sample, xyz, rand)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.double()) for g in grads]))
        if norm >= self.max_norm:
            for g in grads:
                g.mul_((self.max_norm / norm).float())
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.t) * group["mult"]
        self.opt.step()
        self.t += 1
        return (loss.detach(), {k: v.detach() for k, v in terms.items()},
                norm.float(), {k: p.grad.detach().clone()
                               for k, p in self.trained.items()
                               if p.grad is not None})
