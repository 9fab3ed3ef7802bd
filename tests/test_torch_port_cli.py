"""The port's entry points on the CPU at the tiny config: the bench's
function and its JSON line, the train CLI on synthetic data then the eval
CLI on its checkpoint, their refusal to run without CUDA unless asked for
the CPU, and a fresh process that imports every module of the port (and
chip_smoke.py) without importing JAX or the JAX package."""
import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from gaussianformer_tpu_torch import bench
from gaussianformer_tpu_torch import eval as eval_cli
from gaussianformer_tpu_torch.metrics import MeanIoU
from gaussianformer_tpu_torch.train import __main__ as train_cli
from gaussianformer_tpu_torch.utils.checkpoint import latest_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "prob_gs6400_tiny"


def _expected_record(batch, ms):
    """The bench's numbers from its ms a forward, rounded once as the
    root bench.py rounds them: frames/s to 3 places, and vs_baseline
    from the unrounded frames/s."""
    fps = batch / (ms / 1e3)
    return round(fps, 3), round(fps / 10.0, 3)


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_prints_its_json_line(capsys, batch):
    record, ms = bench.run(TINY, batch, "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(line.startswith("#") for line in lines[:-1])
    assert any(line.startswith("# card: ") for line in lines)
    last = json.loads(lines[-1])
    assert last == record
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    suffix = "" if batch == 1 else f"_b{batch}"
    assert last["metric"] == f"{TINY}_infer_fps_cpu{suffix}"
    assert last["unit"] == "frames/s"
    assert (last["value"], last["vs_baseline"]) == _expected_record(batch,
                                                                    ms)
    assert last["value"] > 0


def test_bench_rounds_its_record_once(capsys, monkeypatch):
    """On a host clock that advances 50.089 ms a call, a forward reads
    5.0089 ms: 199.6446 frames/s, whose vs_baseline is 19.964 from the
    unrounded rate and would be 19.965 from the rounded one. The record
    holds the former, as the root bench.py computes it."""
    clock = iter(1000.0 + 0.050089 * i for i in range(1000))
    monkeypatch.setattr(bench, "time",
                        types.SimpleNamespace(perf_counter=lambda: next(clock)))
    record, ms = bench.run(TINY, 1, "cpu")
    assert abs(ms - 5.0089) < 1e-9
    assert (record["value"], record["vs_baseline"]) == _expected_record(1, ms)
    assert record["vs_baseline"] == 19.964
    assert round(record["value"] / 10.0, 3) == 19.965
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == record


def test_train_then_eval_cli(tmp_path, capsys):
    """Two synthetic steps (one epoch of two samples, then the epoch's
    eval), the checkpoint ``latest`` names, and the eval CLI on it: its
    printed line, and counts equal to a direct forward of the loaded
    batches with the generator seeded as eval seeds it."""
    work = str(tmp_path / "work")
    trainer = train_cli.main([
        "--config", TINY, "--work-dir", work, "--synthetic",
        "--synthetic-samples", "2", "--max-epochs", "1", "--num-workers",
        "0", "--print-freq", "1", "--iter-resume", "--device", "cpu"])
    assert (trainer.epoch, trainer.global_iter) == (1, 2)
    assert latest_checkpoint(work) == os.path.join(
        os.path.abspath(work), "ckpt_000000002.pt")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iter"] for r in records] == [1, 2]
    assert all(r["loss"] > 0 and r["step_time"] >= 0 for r in records)
    capsys.readouterr()

    ev = eval_cli.main(["--config", TINY, "--work-dir", work, "--synthetic",
                        "--num-workers", "0", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"mIoU: \d+\.\d\d%  occupancy IoU: \d+\.\d\d%",
                        out[-1])
    ckpt = torch.load(latest_checkpoint(work), weights_only=True)
    for k, v in ev.model.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    metric = MeanIoU()
    gen = torch.Generator().manual_seed(ev.seed)
    with torch.inference_mode():
        for batch in ev.val_loader:
            o = ev.model(batch["imgs"], batch["projection_mat"],
                         batch["image_wh"], batch["occ_xyz"],
                         batch["occ_label"], batch["occ_cam_mask"],
                         generator=gen)
            metric.update(o["final_occ"], o["sampled_label"], o["occ_mask"])
    assert (ev.last_counts == metric.counts).all()
    assert ev.last_counts[-1, 0] > 0


@pytest.mark.parametrize("entry", ["train", "eval", "bench"])
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Without ``--device cpu`` (``device="cpu"``) the entry points refuse
    a host with no CUDA device rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = ["--config", TINY, "--work-dir", str(tmp_path), "--synthetic",
            "--num-workers", "0"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "train":
            train_cli.main(args)
        elif entry == "eval":
            eval_cli.main(args)
        else:
            bench.main([])


def test_runner_refuses_several_processes(tmp_path, monkeypatch):
    """A world of several processes whose process group cannot be set up
    (no address to meet at) raises rather than train as one process of
    many (the port trains in DDP: test_torch_port_ddp.py)."""
    from gaussianformer_tpu_torch.configs import get_config
    from gaussianformer_tpu_torch.train.runner import Trainer
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        Trainer(get_config(TINY), None, None, str(tmp_path), device="cpu")


IMPORT_ALL = """
import importlib, pkgutil, sys
import gaussianformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert {pkg.__name__ + "." + m for m in (
    "losses.focal", "losses.bce", "parallel", "parallel.distributed",
    "train.runner", "eval")} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gaussianformer_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    """Every module of the port, the CLIs included, and chip_smoke.py in a
    fresh interpreter: neither JAX nor the JAX package gets imported. The
    modules chip_smoke.py imports in ``main`` are the port's: no import
    statement of it names jax or gaussianformer_tpu."""
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    assert int(out[0]) >= 40
    assert out[1:] == ["[]"]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|gaussianformer_tpu)\b",
                         src, re.M)
    assert re.search(r"^\s*from gaussianformer_tpu_torch\.", src, re.M)
