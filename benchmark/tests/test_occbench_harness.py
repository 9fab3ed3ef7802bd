"""The harness end to end on the CPU at the program's tiny configs: the
traffic loops, the weights made from the seed, the comparison with the
reference, and the result line; and the measuring command's refusal to
run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import run, synth
from benchmark.reference.model import state_shapes

from .conftest import tiny_cell

# gs25600_solid_tiny (the empty Gaussian) under the v1 cells' limits
CASES = [("prob_gs6400_tiny", "frame", "prob64-frame", 1),
         ("gs144000_tiny", "frame", "gs144k-frame", 1),
         ("prob_gs6400_tiny", "train", "prob64-train", 1),
         ("prob_gs6400_tiny", "frame", "prob64-frame", 2),
         ("gs144000_tiny", "train", "gs144k-train", 1),
         ("gs25600_solid_tiny", "frame", "gs144k-frame", 1),
         ("gs25600_solid_tiny", "train", "gs144k-train", 1)]


@pytest.mark.parametrize("config,loop,workload,batch", CASES)
def test_tiny_run_is_correct(config, loop, workload, batch, bench):
    cell = tiny_cell(config, loop, workload, batch=batch)
    result = run.run_cell(cell, bench, 0.3, False)
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["checked"]) == set(cell.limits)
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in bench["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == names
    json.dumps(result)


def test_same_seed_same_inputs_and_weights():
    cell = tiny_cell("prob_gs6400_tiny", "train", "prob64-train")
    shapes = state_shapes(cell.c)
    a = synth.make_state(shapes, cell.c, 2 ** 31 + 5, "cpu")
    b = synth.make_state(shapes, cell.c, 2 ** 31 + 5, "cpu")
    c = synth.make_state(shapes, cell.c, 2 ** 31 + 6, "cpu")
    assert all(a[k].equal(b[k]) for k in a)
    assert not all(a[k].equal(c[k]) for k in a if a[k].numel() > 1)
    s1 = synth.samples(cell.c, 2, 2 ** 33, "cpu", labels=True)
    s2 = synth.samples(cell.c, 2, 2 ** 33, "cpu", labels=True)
    assert all(s1[i][k].equal(s2[i][k]) for i in range(2) for k in s1[i])
    assert not s1[0]["imgs"].equal(s1[1]["imgs"])


def test_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "prob64-frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr



@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["prob64-frame", "gs144k-frame"])
def test_command_on_the_card(workload, card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
