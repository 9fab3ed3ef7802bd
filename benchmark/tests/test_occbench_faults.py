"""The control and the planted faults fail the comparison, at the tiny
configs on the CPU: the reference one precision step down in the
program's place, and the run driven with its timed path broken: an
answer altered where it is produced and a residual left out of the
encoder (frames), a step that leaves its state unchanged and a DCN
backward that gives half of each gradient (training), at gs144000 the
spconv's weight given half of its gradient and the anchor bank moved by
half of its update, and at gs25600_solid the empty Gaussian left out of
the splat (both) or its scalar's gradient zeroed (training). A train
cell's
batch is one sample, so no half of it can be left out; its cells run on
one chip, with no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from benchmark import readings, run
from benchmark.reference.encoder import operation_order

from .conftest import tiny_cell


def _fails(cell, numbers):
    return any(numbers[k] > v for k, v in cell.limits.items())


@pytest.mark.parametrize("config,loop,workload", [
    ("prob_gs6400_tiny", "frame", "prob64-frame"),
    ("gs144000_tiny", "frame", "gs144k-frame"),
    ("prob_gs6400_tiny", "train", "prob64-train"),
    ("gs144000_tiny", "train", "gs144k-train")])
def test_control_fails(config, loop, workload):
    cell = tiny_cell(config, loop, workload)
    assert _fails(cell, readings.planted(cell, "control"))


@pytest.mark.parametrize("config,workload", [
    ("prob_gs6400_tiny", "prob64-frame"), ("gs144000_tiny", "gs144k-frame")])
def test_altered_labels_fail(config, workload, bench, monkeypatch):
    from gaussianformer_tpu_torch.models import segmentor
    real = segmentor.BEVSegmentor.forward

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        occ = out["final_occ"]
        occ[:, ::50] = (occ[:, ::50] + 1) % 18
        return out
    monkeypatch.setattr(segmentor.BEVSegmentor, "forward", altered)
    result = run.run_cell(tiny_cell(config, "frame", workload), bench, 0.3,
                          False)
    assert not result["correct"]


def test_residual_left_out_fails(bench, monkeypatch):
    """The program's encoder skips its last residual add: each operation
    still gives what the reference gives on its arguments, so only the
    check of how the stages are put together sees it."""
    from gaussianformer_tpu_torch.models.encoder import gaussian_encoder
    cls = gaussian_encoder.GaussianOccEncoder
    real = cls.forward
    cell = tiny_cell("prob_gs6400_tiny", "frame", "prob64-frame")
    order = list(operation_order(cell.c))
    last_add = len(order) - 1 - order[::-1].index("add")

    def skipping(self, *args, **kwargs):
        keep = self.operation_order
        self.operation_order = tuple(
            "identity" if i == last_add else op for i, op in enumerate(keep))
        try:
            return real(self, *args, **kwargs)
        finally:
            self.operation_order = keep
    monkeypatch.setattr(cls, "forward", skipping)
    result = run.run_cell(cell, bench, 0.3, False)
    assert not result["correct"]
    assert result["checked"]["wiring_rel"]["value"] > \
        result["checked"]["wiring_rel"]["limit"]


TRAIN_CELLS = [("prob_gs6400_tiny", "train", "prob64-train"),
               ("gs144000_tiny", "train", "gs144k-train")]


@pytest.mark.parametrize("config,traffic,workload", TRAIN_CELLS)
def test_train_step_leaving_its_state_fails(config, traffic, workload, bench,
                                            monkeypatch):
    from gaussianformer_tpu_torch.train import step
    real = step.train_step

    def frozen(model, opt, schedule, loss_fn, batch, generator):
        keep = [p.detach().clone() for p in model.parameters()]
        out = real(model, opt, schedule, loss_fn, batch, generator)
        with torch.no_grad():
            for p, k in zip(model.parameters(), keep):
                p.copy_(k)
        return out
    monkeypatch.setattr(step, "train_step", frozen)
    cell = tiny_cell(config, traffic, workload)
    result = run.run_cell(cell, bench, 0.3, False)
    assert not result["correct"]


@pytest.mark.parametrize("config,traffic,workload", TRAIN_CELLS)
def test_dcn_backward_halved_fails(config, traffic, workload, bench):
    cell = tiny_cell(config, traffic, workload)
    with readings.dcn_backward_halved():
        result = run.run_cell(cell, bench, 0.3, False)
    assert not result["correct"]
    assert result["checked"]["dcn_grad_rel"]["value"] > \
        result["checked"]["dcn_grad_rel"]["limit"]


@pytest.mark.parametrize("config,loop,workload,fault,caught", [
    ("gs25600_solid_tiny", "frame", "gs144k-frame",
     "empty_gaussian_left_out", "labels_off"),
    ("gs25600_solid_tiny", "train", "gs144k-train",
     "empty_gaussian_left_out", "head_rel"),
    ("gs25600_solid_tiny", "train", "gs144k-train",
     "empty_scalar_grad_zeroed", "head_grad_rel"),
    ("gs144000_tiny", "train", "gs144k-train",
     "spconv_weight_grad_halved", "spconv_grad_rel"),
    ("gs144000_tiny", "train", "gs144k-train",
     "bank_update_halved", "change_leaf_gap")])
def test_planted_faults_fail(config, loop, workload, fault, caught, bench):
    cell = tiny_cell(config, loop, workload)
    with readings.FAULTS[fault]():
        result = run.run_cell(cell, bench, 0.3, False)
    assert not result["correct"]
    assert result["checked"][caught]["value"] > \
        result["checked"][caught]["limit"]
