"""Every cell of ``BENCHMARK.json`` is made by ``run.make_cell``, whose
start checks the configuration file against the program's config of its
``port_config``; and each configuration file is the one that
``BENCHMARK.json`` names, with its source and cuts."""
from __future__ import annotations

import json

import pytest

from benchmark import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_make_cell_accepts_the_config_file(workload):
    cell = run.make_cell(workload, 0, "cpu")
    conf = run.load_json(run.HERE / "configs" / f"{workload['config']}.json")
    assert cell.c == conf["config"]
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == workload["config"])
    assert entry["file"] == f"benchmark/configs/{workload['config']}.json"
    assert entry["source"] == conf["source"]
    assert entry["reduced"] == conf["reduced"]
