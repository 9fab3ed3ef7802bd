"""Fixtures of the benchmark's CPU tests: the program's tiny configs as
cells on the CPU, the measuring command's look for a card skipped."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.reference.model import state_shapes

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(config: str, loop: str, workload: str, seed: int = 11,
              **traffic):
    """The cell ``workload``'s traffic and limits on the program's tiny
    ``config`` (``tests/data``), on the CPU, with a ring of 3."""
    from gaussianformer_tpu_torch.configs import get_config
    conf = json.loads((DATA / f"{config}.json").read_text())
    tr, limits = run.with_checks(
        json.loads((run.HERE / "traffic" / f"{loop}.json").read_text()),
        json.loads((run.HERE / "checks" / f"{workload}.json").read_text()))
    tr.update(ring=3, **traffic)
    return run.Cell(name=workload, c=conf["config"], cfg=get_config(config),
                    traffic=tr, limits=limits, seed=seed, device="cpu",
                    shapes=state_shapes(conf["config"]))


@pytest.fixture(autouse=True)
def _threads():
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


@pytest.fixture
def bench():
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
