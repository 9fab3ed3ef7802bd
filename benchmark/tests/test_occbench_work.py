"""The frozen work counts of work/flops.py against PyTorch's own FLOP
counter over the reference's forward, and its backward, at the tiny
configs: the convolutions and matrix products of the towers, the lifter's
tower and depth projection, and the encoder."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import synth
from benchmark.reference.model import Model, state_shapes
from benchmark.work.flops import BLOCKS, model_work

from .conftest import DATA

COUNTED = ("convolution", "convolution_backward", "mm", "addmm")


def _counted(counter):
    return sum(v for op, v in counter.get_flop_counts()["Global"].items()
               if str(op).split(".")[1] in COUNTED)


def _forward(model, c, sample):
    maps = model.towers(sample["imgs"])
    b = sample["imgs"].shape[0]
    if c["version"] == 2:
        lf = model.lifter
        _, logits = lf.pixel_logits(sample["imgs"])
        xyz = torch.zeros(b, c["num_anchor"], 3)
        anchor, feat = lf.representation(xyz)
        extra = logits.sum()
    else:
        anchor, feat = model.lifter.representation(b)
        extra = 0.0
    preds = model.encoder(anchor, feat, maps, sample["projection_mat"],
                          sample["image_wh"])
    return extra + sum(t.sum() for g in preds for t in g)


@pytest.mark.parametrize("config", ["prob_gs6400_tiny", "gs144000_tiny"])
def test_work_matches_flop_counter(config):
    c = json.loads((DATA / f"{config}.json").read_text())["config"]
    model = Model(c)
    model.load_state_dict(synth.make_state(state_shapes(c), c, 3, "cpu"))
    sample = synth.samples(c, 1, 3, "cpu", labels=False)[0]
    work = model_work(c)
    with FlopCounterMode(display=False) as fwd:
        loss = _forward(model, c, sample)
    assert _counted(fwd) == pytest.approx(work.forward, rel=1e-12)
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    assert _counted(bwd) == pytest.approx(work.backward, rel=1e-12)
    dcn = sum(n for n, on in zip(BLOCKS[c["depth"]], c["stage_with_dcn"])
              if on)
    assert len(work.dcn) == dcn * (2 if c["version"] == 2 else 1)
