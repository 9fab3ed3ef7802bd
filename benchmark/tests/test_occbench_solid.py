"""GaussianFormer NonEmpty (``gs25600_solid``) and its cell
``solid-train``: the program's tiny variant in a train step is correct
under the cell's own limits, and the control, the empty Gaussian left out
of the splat, its scalar's gradient zeroed or the anchor bank left as it
was is not; the reader of ``splat_bwd_ms.train`` reads the program's span,
and nothing where the program has none. On the card (marker ``cuda``):
the cell's command end to end."""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys

import pytest
import torch

from benchmark import readings, run

from .conftest import tiny_cell


def test_tiny_train_step_is_correct_under_the_cells_limits(bench):
    cell = tiny_cell("gs25600_solid_tiny", "train", "solid-train")
    assert cell.limits == {k: v for k, v in json.loads(
        (run.HERE / "checks" / "solid-train.json").read_text()).items()
        if k != run.STEPS}
    result = run.run_cell(cell, bench, 0.3, False)
    assert result["correct"], result["checked"]
    assert set(result["checked"]) == set(cell.limits)
    assert set(result["metrics"]) == {"step_ms", "train_peak_gib",
                                      "setup_s"}


def test_control_fails_the_cells_limits():
    """The reference one precision step down in the program's place."""
    cell = tiny_cell("gs25600_solid_tiny", "train", "solid-train")
    numbers = readings.planted(cell, "control")
    assert any(numbers[k] > v for k, v in cell.limits.items())


@contextlib.contextmanager
def bank_update_skipped():
    """The program's train step leaving its v1 anchor bank
    (``lifter.anchor``, the opacities included) as it was."""
    from gaussianformer_tpu_torch.train import step
    real = step.train_step

    def skipped(model, *args, **kwargs):
        bank = model.lifter.anchor
        keep = bank.detach().clone()
        out = real(model, *args, **kwargs)
        with torch.no_grad():
            bank.copy_(keep)
        return out
    step.train_step = skipped
    try:
        yield
    finally:
        step.train_step = real


#: faults planted in the program: those of the readings, and one leaf left
#: as it was, which the worst leaf's change (``change_leaf_gap``) reads
FAULTS = dict(readings.FAULTS, bank_update_skipped=bank_update_skipped)


@pytest.mark.parametrize("fault,caught", [
    ("empty_gaussian_left_out", "head_rel"),
    ("empty_scalar_grad_zeroed", "head_grad_rel"),
    ("bank_update_skipped", "change_leaf_gap")])
def test_planted_faults_fail_the_cells_limits(fault, caught, bench):
    cell = tiny_cell("gs25600_solid_tiny", "train", "solid-train")
    with FAULTS[fault]():
        result = run.run_cell(cell, bench, 0.3, False)
    assert not result["correct"]
    got = result["checked"][caught]
    assert got["value"] > got["limit"]


def _span(device_ms, calls):
    return {"calls": calls, "host_ms": 1.0, "self_host_ms": 1.0,
            "device_ms": device_ms, "self_device_ms": device_ms}


def test_splat_backward_reader():
    """Device ms a step of ``splat_bwd``, over every call of the stretch;
    None in a frame cell, without the span (a program that has none), or
    without a traced stretch."""
    name = "splat_bwd_ms.train"
    program = {"count": 4, "spans": {"splat_bwd": _span(6.0, calls=16)}}
    assert run.read_metric(name, {"loop": "train", "program": program}) \
        == pytest.approx(1.5)
    assert run.read_metric(name, {"loop": "frame", "program": program}) \
        is None
    assert run.read_metric(name, {"loop": "train", "program": {
        "count": 4, "spans": {"step/backward": _span(80.0, calls=4)}}}) \
        is None
    assert run.read_metric(name, {"loop": "train", "program": None}) is None


@pytest.mark.cuda
def test_command_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "solid-train",
         "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["splat_bwd_ms.train"]["value"] > 0
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
