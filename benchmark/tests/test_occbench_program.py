"""The per-layer metrics that read the program's own spans and counters
(``benchmark/program.py``): each reader's number from a hand-made
``ctx["program"]``, nothing without one, the program-traced stretch of a
tiny frame and train cell on the CPU, and idle gaps put down to the
innermost program span."""
from __future__ import annotations

import types

import pytest
import torch

from benchmark import program, run

from .conftest import tiny_cell


def _span(device_ms, host_ms=1.0, calls=4):
    return {"calls": calls, "host_ms": host_ms, "self_host_ms": host_ms,
            "device_ms": device_ms, "self_device_ms": device_ms}


PROGRAM = {"count": 4, "calls": 4, "launches": {}, "idle": {},
           "counters": {"splat_entries": 1000, "host_syncs": 8},
           "spans": {"encoder/spconv": _span(60.0, calls=16),
                     "encoder": _span(100.0),
                     "sync/splat_flags": _span(None, host_ms=6.0),
                     "sync/splat_capacity": _span(None, host_ms=2.0),
                     "step/forward": _span(80.0),
                     "step/losses": _span(12.0),
                     "step/clip": _span(8.0),
                     "step/update": _span(20.0, host_ms=48.0)}}

#: metric -> (loop, its number from PROGRAM)
READINGS = {"spconv_ms.frame": ("frame", 15.0),
            "splat_entries.frame": ("frame", 250.0),
            "host_sync_ms.frame": ("frame", 2.0),
            "forward_ms.train": ("train", 20.0),
            "losses_ms.train": ("train", 3.0),
            "clip_ms.train": ("train", 2.0),
            "update_host_ms.train": ("train", 12.0),
            "host_sync_ms.train": ("train", 2.0)}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_the_program(name, bench):
    loop, want = READINGS[name]
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    ctx = {"loop": loop, "program": PROGRAM}
    assert run.read_metric(name, ctx) == pytest.approx(want)
    other = "train" if loop == "frame" else "frame"
    assert run.read_metric(name, {"loop": other, "program": PROGRAM}) \
        is None


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_without_the_program_reads_nothing(name):
    """No program-traced stretch (a parent without the tracing module, a
    run on the CPU or without a workload): None, and no error."""
    loop = READINGS[name][0]
    assert run.read_metric(name, {"loop": loop, "program": None}) is None
    ctx = {"loop": loop}
    assert run.read_metric(name, ctx) is None
    assert ctx["program"] is None


@pytest.mark.parametrize("config,loop,workload,spans", [
    ("prob_gs6400_tiny", "frame", "prob64-frame",
     {"forward", "lifter/fps", "encoder/spconv", "head/bins"}),
    ("gs144000_tiny", "frame", "gs144k-frame",
     {"forward", "encoder/spconv", "head/splat"}),
    ("prob_gs6400_tiny", "train", "prob64-train",
     {"step", "step/forward", "step/losses", "step/backward", "step/clip",
      "step/update", "dcn_bwd"})])
def test_traced_stretch_on_the_cpu(config, loop, workload, spans):
    """One pass over the ring with the program's tracing on: its spans, the
    ring's count, no device time and no idle attribution on the CPU, and
    the tracing off again after it."""
    from gaussianformer_tpu_torch.utils import profiling
    cell = tiny_cell(config, loop, workload)
    got = program.traced_stretch(cell)
    assert not profiling.enabled()
    assert got["count"] == 3 == got["calls"]
    assert spans <= set(got["spans"])
    assert got["spans"]["encoder/spconv"]["device_ms"] is None
    assert got["idle"] == {} and got["wall_s"] > 0


def _event(name, start, end, device):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=name, device_type=kind, is_user_annotation=False,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_idle_goes_to_the_innermost_span():
    """Gaps (us) between device operations: one at 100 inside gf/head and
    gf/head/bins, one at 300 inside gf/head alone, one at 500 outside
    every span, and none where operations overlap."""
    events = [
        _event("gf/head", 50, 450, False),
        _event("gf/head/bins", 90, 150, False),
        _event("aten::item", 95, 140, False),
        _event("k1", 0, 100, True), _event("k2", 130, 200, True),
        _event("k3", 180, 300, True), _event("k4", 340, 500, True),
        _event("k5", 520, 600, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert program.idle_by_span(prof) == {
        "head/bins": pytest.approx(0.030), "head": pytest.approx(0.040),
        program.NO_SPAN: pytest.approx(0.020)}
