"""The harness is driven by data: a configuration, a traffic mix, a cell,
its limits, a per-layer metric and a traffic file's loop are found by
their names, so a later change adds them as files."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark import run

SCRIPT = r"""
import json, sys
sys.path.insert(0, ".")
from benchmark import loops, run
w, bench = run.spec("prob64-frame-short")
cell = run.make_cell(w, 5, "cpu")
ctx = {"loop": "frame", "spans": {"towers": 30.0}, "count": 3}
print(json.dumps({"traffic": cell.traffic, "limits": cell.limits,
                  "metric": run.read_metric("towers_ms.short", ctx),
                  "loop": loops.find(cell.traffic["loop"])(cell, 1, 0, 0)}))
"""


def test_new_traffic_cell_and_metric_found_by_name(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "prob64-frame-short",
                               "config": "prob_gs6400",
                               "traffic": "frame_short", "chips": 1,
                               "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {"loop": "burst", "batch": 2, "ring": 2, "warmup": 1}
    (tmp_path / "benchmark" / "loops" / "burst.py").write_text(
        "def run(cell, seconds, trace_on, t_start):\n"
        "    return cell.traffic['batch'] * 10\n")
    (tmp_path / "benchmark" / "traffic" / "frame_short.json").write_text(
        json.dumps(new))
    (tmp_path / "benchmark" / "checks" / "prob64-frame-short.json"
     ).write_text(json.dumps({"towers_rel": 0.5}))
    (tmp_path / "benchmark" / "metrics" / "towers_ms.short.py").write_text(
        "def read(ctx):\n    return ctx['spans']['towers'] / ctx['count']\n")
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {"traffic": new, "limits": {"towers_rel": 0.5},
                   "metric": 10.0, "loop": 20}
