"""The plain reference's recomputation: the train step's losses and
gradients with the encoder's operations recomputed in the backward equal
those with every operation's autograd memory held, and the deformable
sampling in pieces of anchors gives what it gives in one piece; and the
anchors it finds at an image's edge."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import control, synth
from benchmark.reference import encoder
from benchmark.reference.model import Model, state_shapes

from .conftest import DATA


def _losses_and_grads(c, recompute: bool, seed: int = 5):
    """The first train step's loss terms and every parameter's gradient
    of the reference at ``c``, its encoder recomputed or not."""
    model = Model(c, checkpoint=True)
    model.encoder.checkpoint = recompute
    model.load_state_dict(synth.make_state(state_shapes(c), c, seed, "cpu"))
    sample = synth.samples(c, 1, seed, "cpu", labels=True)[0]
    drawer = control.Drawer(synth.generator(seed, synth.DROPOUT, "cpu"),
                            "cpu")
    xyz = (control.lifter_xyz(model, sample, drawer.lifter(c, 1))
           if c["version"] == 2 else None)
    with torch.enable_grad():
        loss, terms = model.losses(sample, xyz, drawer.rand)
        loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return terms, grads, len(drawer.draws)


def _config(name):
    return json.loads((DATA / f"{name}.json").read_text())["config"]


@pytest.mark.parametrize("config", ["gs144000_tiny", "prob_gs6400_tiny"])
def test_recomputed_encoder_changes_nothing(config):
    c = _config(config)
    held, held_grads, held_draws = _losses_and_grads(c, False)
    again, again_grads, again_draws = _losses_and_grads(c, True)
    # the dropout uniforms are drawn once, before each operation runs
    assert again_draws == held_draws > 0
    assert held.keys() == again.keys()
    assert all(torch.equal(held[k], again[k]) for k in held)
    assert held_grads.keys() == again_grads.keys()
    assert any(k.startswith("encoder.layers.") and "output_proj" in k
               for k in held_grads)
    assert all(torch.equal(held_grads[k], again_grads[k])
               for k in held_grads)


def test_sampling_in_pieces(monkeypatch):
    """Pieces of 5 anchors against one piece: the same forward; the
    feature maps' gradients summed over the pieces, so equal to
    rounding."""
    g = torch.Generator().manual_seed(3)
    maps = [torch.randn(1, 6, h, w, 16, generator=g, requires_grad=True)
            for h, w in ((8, 12), (4, 6))]
    loc = torch.rand(1, 23 * 3, 6, 2, generator=g, requires_grad=True)
    wts = torch.rand(1, 23 * 3, 6, 2, 4, generator=g, requires_grad=True)

    def run():
        out = encoder.aggregate(maps, loc, wts, 3, encoder.REFERENCE)
        grads = torch.autograd.grad(out.square().sum(), [*maps, loc, wts])
        return out.detach(), grads
    whole, whole_grads = run()
    monkeypatch.setattr(encoder, "CHUNK", 5)
    pieces, piece_grads = run()
    assert torch.equal(whole, pieces)
    for a, b in zip(whole_grads, piece_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_edge_anchors(monkeypatch):
    """No anchor is at an edge within 0; within 2 every anchor with a key
    point in front of a camera is."""
    c = _config("gs144000_tiny")
    model = Model(c)
    model.load_state_dict(synth.make_state(state_shapes(c), c, 7, "cpu"))
    layer = model.encoder.layers[model.encoder.order.index("deformable")]
    sample = synth.samples(c, 1, 7, "cpu", labels=False)[0]
    anchor, feat = model.lifter.representation(1)
    args = (feat, anchor, sample["projection_mat"], sample["image_wh"])
    monkeypatch.setattr(encoder, "EDGE", 0.0)
    assert not layer.edge_anchors(*args).any()
    monkeypatch.setattr(encoder, "EDGE", 2.0)
    _, depth = encoder.project(layer.kps_generator(anchor, feat), *args[2:])
    front = (depth > 1e-5).any(-1).any(1)
    assert front.any()
    assert torch.equal(layer.edge_anchors(*args), front)
