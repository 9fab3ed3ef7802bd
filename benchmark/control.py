"""Systems put in the program's place to read the limits' upper ends: the
reference at the precision one step down (``Precision.control()``), or
at the precision the configuration states. Each gives what the comparison reads
from the program: a frame's stages (:func:`frame_stages`) or the first
steps of training (:func:`train_steps`). The benchmark's own runs never
use this module; ``readings.py`` and the tests do."""
from __future__ import annotations

import contextlib

import torch

from .check import FrameCapture, GradCapture
from .reference.model import TrainStep


class Drawer:
    """Fresh draws from ``generator``, recorded as the program's step
    records its own (``loops.DrawRecorder``)."""

    def __init__(self, generator, device):
        self.generator = generator
        self.device = device
        self.draws = []

    def _keep(self, kind, t):
        self.draws.append((kind, t))
        return t

    def rand(self, shape):
        return self._keep("rand", torch.rand(
            tuple(shape), generator=self.generator, device=self.device))

    def randint(self, high, shape):
        return self._keep("randint", torch.randint(
            0, high, tuple(shape), generator=self.generator,
            device=self.device))

    def randn(self, shape):
        return self._keep("randn", torch.randn(
            tuple(shape), generator=self.generator, device=self.device))

    def lifter(self, c, batch):
        """(pick, noise, u) in the order the program's lifter draws them
        in a step: the depth uniforms first."""
        h, w = c["input_size"]
        n = c["num_cams"]
        cand = n * (h // 8) * (w // 8)
        u = self.rand((batch, n, h // 8, w // 8, 1))
        return (self.randint(cand, (batch, cand)),
                self.randn((batch, cand, 3)) * 0.1, u)


def frame_stages(model, sample, draws):
    """A frame of the reference ``model`` (at its own precision) with the
    stages the comparison reads, and its labels."""
    c = model.c
    cap = FrameCapture(model)
    with torch.no_grad(), model.prec.matmul(), cap.on():
        imgs = sample["imgs"]
        b = imgs.shape[0]
        maps = model.towers(imgs)
        if c["version"] == 2:
            lf = model.lifter
            _, logits = lf.pixel_logits(imgs)
            origin, ray = lf.rays(sample["projection_mat"],
                                  sample["image_wh"], *logits.shape[2:4])
            xyz = lf.anchors_xyz(lf.candidates(logits, origin, ray, draws))
            anchor, inst = lf.representation(xyz)
        else:
            anchor, inst = model.lifter.representation(b)
        preds = model.encoder(anchor, inst, maps, sample["projection_mat"],
                              sample["image_wh"])
        _, labels = model.head(preds, sample["occ_xyz"])
    return cap.data, labels


def lifter_xyz(model, sample, draws):
    """The anchors' positions the reference ``model``'s own lifter
    picks."""
    lf = model.lifter
    with torch.no_grad(), model.prec.matmul():
        _, logits = lf.pixel_logits(sample["imgs"])
        origin, ray = lf.rays(sample["projection_mat"], sample["image_wh"],
                              *logits.shape[2:4])
        return lf.anchors_xyz(lf.candidates(logits, origin, ray, draws))


def train_steps(model, ring, generator, total_steps, steps=3):
    """The first ``steps`` train steps of the reference ``model`` (at its
    own precision), as the comparison reads the program's: each step's
    loss, gradient norm, draws and anchors, the first step's clipped
    gradient, stages and stages' backward, the change of each trained
    leaf."""
    c = model.c
    step = TrainStep(model, total_steps)
    start = {k: p.detach().clone() for k, p in step.trained.items()}
    sut = {"loss": [], "grad_norm": [], "draws": [], "xyz": []}
    dev = ring[0]["imgs"].device
    grads = GradCapture(model)
    for s in range(steps):
        drawer = Drawer(generator, dev)
        sample = ring[s]
        xyz = None
        capture = FrameCapture(model, detach=True)
        with capture.on(), (grads.on() if s == 0 else
                             contextlib.nullcontext()):
            if c["version"] == 2:
                xyz = lifter_xyz(model, sample, drawer.lifter(
                    c, sample["imgs"].shape[0]))
            with torch.enable_grad():
                loss, _, norm, clipped = step(sample, xyz, drawer.rand)
        sut["loss"].append(loss.item())
        sut["grad_norm"].append(norm.item())
        sut["draws"].append(drawer.draws)
        sut["xyz"].append(xyz)
        if s == 0:
            sut["grad"] = clipped
            sut["stages"] = capture.data
            sut["grads"] = grads.data
    sut["change"] = {k: p.detach() - start[k]
                     for k, p in step.trained.items()}
    return sut
