"""Multi-process training of the PyTorch port on the CPU: torch DDP over
gloo, two processes (and one), at the tiny configs.

Each run starts its processes as ``python tests/test_torch_port_ddp.py
<mode> ...`` with torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), one intra-op thread each, and
every process has a timeout, so a hang fails rather than stalls the
suite. The modes:

- ``cli``: the train CLI for one epoch of 4 synthetic samples (2 steps a
  rank), then the eval CLI on its checkpoint (1 of the 2 val samples a
  rank); records each step's gradients as the optimizer saw them, the
  final parameters, both evaluations' counts and who saved;
- ``accumulate``: a Trainer with gradient accumulation 2 on 4 samples
  (one update a rank);
- ``plain`` / ``world1``: the train CLI on prob_gs6400_tiny with no
  process group and in a world of one, for bit equality.

The references are computed in the test process from the same weights,
samples and per-rank generators (``train.runner.step_generator``). DDP
averages the ranks' gradients of their own losses (the upstream
reference's DDP), so the references are means over the ranks of
single-process gradients.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gaussianformer_tpu_torch.configs import get_config  # noqa: E402
from gaussianformer_tpu_torch.data import ShardedSampler  # noqa: E402
from gaussianformer_tpu_torch.data.loader import collate  # noqa: E402
from gaussianformer_tpu_torch.metrics import (MeanIoU,  # noqa: E402
                                              compute_iou)
from gaussianformer_tpu_torch.models.segmentor import \
    build_segmentor  # noqa: E402
from gaussianformer_tpu_torch.train.runner import (  # noqa: E402
    build_dataset, step_generator)
from gaussianformer_tpu_torch.train.step import (build_loss,  # noqa: E402
                                                 global_norm)

PROCESS_TIMEOUT = 300
TRAIN_SAMPLES = 4
# gradients of one sample through the whole tiny model, in another
# process and summed over the ranks in another order: each leaf to 1e-5
# of its norm
GRAD_REL = 1e-5


# ------------------------------------------------------------ the workers
def _record_steps(runner):
    """Wrap the runner's train step: each call's gradients as the optimizer
    read them (averaged over the ranks, clipped) and its metrics."""
    steps = []
    inner = runner.train_step

    def recording(model, *args, **kwargs):
        metrics = inner(model, *args, **kwargs)
        module = getattr(model, "module", model)
        steps.append({n: p.grad.detach().clone()
                      for n, p in module.named_parameters()})
        return metrics
    runner.train_step = recording
    return steps


def _record_saves(runner):
    saves = []
    inner = runner.save_checkpoint

    def recording(work_dir, step, state):
        saves.append(step)
        return inner(work_dir, step, state)
    runner.save_checkpoint = recording
    return saves


def _worker(mode, config, work, out):
    torch.set_num_threads(1)
    from gaussianformer_tpu_torch import eval as eval_cli
    from gaussianformer_tpu_torch.parallel import shutdown_distributed
    from gaussianformer_tpu_torch.train import __main__ as train_cli
    from gaussianformer_tpu_torch.train import runner
    steps, saves = _record_steps(runner), _record_saves(runner)
    common = ["--config", config, "--synthetic", "--num-workers", "0",
              "--device", "cpu", "--work-dir", work]
    rec = {}
    if mode == "accumulate":
        from gaussianformer_tpu_torch.data import DataLoader
        from gaussianformer_tpu_torch.parallel import init_distributed
        rank, world = init_distributed("cpu")
        runner.setup_logging(work if rank == 0 else None)
        cfg = get_config(config)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, max_epochs=1))
        ds = build_dataset(cfg, "train", synthetic=True,
                           num_samples=TRAIN_SAMPLES)
        loader = DataLoader(ds, 1, sampler=ShardedSampler(
            len(ds), shard_id=rank, num_shards=world, seed=0))
        trainer = runner.Trainer(cfg, loader, None, work, print_freq=1,
                                 grad_accumulation=2, device="cpu")
        trainer.fit()
        rec["update_grads"] = {n: p.grad.detach().clone()
                               for n, p in trainer.model.named_parameters()}
    else:
        trainer = train_cli.main(common + [
            "--synthetic-samples", str(TRAIN_SAMPLES if mode == "cli"
                                       else 2),
            "--max-epochs", "1", "--print-freq", "1"])
        rec["fit_counts"] = trainer.last_counts
        if mode == "cli":
            rec["eval_counts"] = eval_cli.main(common).last_counts
            # MeanIoU.result over the group: per row (seen, correct,
            # positive) (2, 1, 1) on rank 0 and (1, 1, 3) on rank 1
            metric = MeanIoU()
            metric.counts[:] = [(2, 1, 1), (1, 1, 3)][trainer.rank]
            rec["result"] = metric.result(distributed=True)[:2]
    rec.update(steps=steps, saves=saves, global_iter=trainer.global_iter,
               params={n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()})
    torch.save(rec, out)
    shutdown_distributed()


# ------------------------------------------------------------- launching
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(mode, config, world, root):
    """Start the run's processes; world 0: one process, no process
    group. Returns (processes, work dir, output files)."""
    work = os.path.join(root, f"{mode}_{config}_{world}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID",
                        "COORDINATOR_ADDRESS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs, outs = [], []
    for rank in range(max(world, 1)):
        out = os.path.join(root, f"{mode}_{config}_{world}_rank{rank}.pt")
        penv = dict(env)
        if world:
            penv.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                        WORLD_SIZE=str(world), RANK=str(rank),
                        LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, config, work,
             out], cwd=REPO, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    return procs, work, outs


def _finish(run):
    procs, work, outs = run
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return work, [torch.load(o, weights_only=False) for o in outs]


RUNS = {"cli_solid": ("cli", "gs25600_solid_tiny", 2),
        "cli_144k": ("cli", "gs144000_tiny", 2),
        "accumulate": ("accumulate", "gs25600_solid_tiny", 2),
        "plain": ("plain", "prob_gs6400_tiny", 0),
        "world1": ("world1", "prob_gs6400_tiny", 1)}


@pytest.fixture(scope="module")
def runs():
    """Every run's processes, started together; each run's work dir,
    per-rank records, ``train.log`` and ``metrics.jsonl`` records."""
    with tempfile.TemporaryDirectory(prefix="gf_ddp_") as root:
        started = {k: _start(*v, root) for k, v in RUNS.items()}
        done = {}
        for k, run in started.items():
            work, ranks = _finish(run)
            with open(os.path.join(work, "train.log")) as f:
                log = f.read()
            with open(os.path.join(work, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            done[k] = dict(work=work, ranks=ranks, log=log, metrics=metrics)
        yield done


# ------------------------------------------------------------ references
def _sample_grads(config, samples, generators):
    """Single-process gradients of one sample each, at the seed-0 weights,
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config(config)
        model = build_segmentor(cfg, device="cpu", seed=0)
        loss_fn = build_loss(cfg)
        ds = build_dataset(cfg, "train", synthetic=True,
                           num_samples=TRAIN_SAMPLES)
        out = []
        for i, gen in zip(samples, generators):
            b = collate([ds[i]])
            model.zero_grad(set_to_none=True)
            res = model(b["imgs"], b["projection_mat"], b["image_wh"],
                        b["occ_xyz"], b["occ_label"], b["occ_cam_mask"],
                        training=True, generator=gen)
            loss_fn(res)[0].backward()
            out.append({n: p.grad.detach().clone()
                        for n, p in model.named_parameters()})
        return out
    finally:
        torch.set_num_threads(threads)


def _shard(rank, world=2):
    return list(ShardedSampler(TRAIN_SAMPLES, shard_id=rank,
                               num_shards=world, shuffle=True, seed=0))


def _clipped(grads, max_norm=35.0):
    norm = global_norm(list(grads.values()))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {n: g * scale for n, g in grads.items()}


def _assert_grads(got, ref):
    assert set(got) == set(ref)
    bad = {}
    for n, r in ref.items():
        rel = ((got[n] - r).norm() / r.norm().clamp_min(1e-30)).item()
        if not (rel <= GRAD_REL or (got[n] - r).abs().max() <= 1e-12):
            bad[n] = rel
    assert not bad, bad


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("world", [1, 2, 3])
def test_sampler_shards_are_disjoint_and_cover(world):
    """For 4 and 5 samples, each epoch: the ranks' shards are disjoint
    where the set divides evenly, padded by wrapping around (as torch's
    DistributedSampler) where it does not, and together cover the set."""
    for n in (4, 5):
        for epoch in (0, 1):
            shards = []
            for r in range(world):
                s = ShardedSampler(n, shard_id=r, num_shards=world, seed=3)
                s.set_epoch(epoch)
                shards.append(list(s))
            flat = sum(shards, [])
            assert len({len(s) for s in shards}) == 1
            assert set(flat) == set(range(n))
            assert len(flat) == -(-n // world) * world
            if n % world == 0:
                assert len(flat) == len(set(flat))


@pytest.mark.parametrize("run", ["cli_solid", "cli_144k"])
def test_reduced_gradient_is_the_mean_of_the_ranks(runs, run):
    """The first step's gradient on both ranks equals the mean of the two
    ranks' single-process gradients on their own samples (with their own
    dropout draws), clipped; every parameter has one (random_1 supervises
    the last refine layer, ``all`` every one: DDP needs no search for
    unused parameters, and a second step ran without it)."""
    _, config, world = RUNS[run]
    ranks = runs[run]["ranks"]
    assert all(len(r["steps"]) == 2 for r in ranks)
    ref = _sample_grads(config, [_shard(r)[0] for r in range(world)],
                        [step_generator(0, 0, r) for r in range(world)])
    mean = _clipped({n: (ref[0][n] + ref[1][n]) / 2 for n in ref[0]})
    for r in ranks:
        _assert_grads(r["steps"][0], mean)
    # the ranks' own gradients differ: the mean is not one of them
    n = "lifter.anchor"
    assert (ref[0][n] - ref[1][n]).norm() > 1e-3 * ref[0][n].norm()


@pytest.mark.parametrize("run", ["cli_solid", "cli_144k", "accumulate"])
def test_parameters_identical_across_ranks(runs, run):
    ranks = runs[run]["ranks"]
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    start = build_segmentor(get_config(RUNS[run][1]), device="cpu", seed=0)
    moved = [n for n, p in start.named_parameters()
             if not torch.equal(p.detach(), ranks[0]["params"][n])]
    assert "lifter.anchor" in moved


def test_world_of_one_equals_a_plain_run(runs):
    """prob_gs6400_tiny, one epoch of 2 samples and its eval: DDP in a
    world of one (gloo) gives the bits of a run with no process group:
    every step's gradients, the final parameters, the logged losses and
    the eval counts."""
    plain, one = runs["plain"]["ranks"][0], runs["world1"]["ranks"][0]
    assert "backend gloo" in runs["world1"]["log"]
    assert "DistributedDataParallel" in runs["world1"]["log"]
    assert "DistributedDataParallel" not in runs["plain"]["log"]
    assert len(plain["steps"]) == len(one["steps"]) == 2
    for a, b in zip(plain["steps"], one["steps"]):
        for n in a:
            assert torch.equal(a[n], b[n]), n
    for n, p in plain["params"].items():
        assert torch.equal(p, one["params"][n]), n
    strip = [{k: v for k, v in r.items()
              if k not in ("time", "data_time", "step_time")}
             for r in runs["plain"]["metrics"]]
    assert strip == [{k: v for k, v in r.items()
                      if k not in ("time", "data_time", "step_time")}
                     for r in runs["world1"]["metrics"]]
    assert (plain["fit_counts"] == one["fit_counts"]).all()


def test_no_sync_accumulation_equals_the_mean_update(runs):
    """Accumulation 2 in a world of two: each rank's two micro-steps run
    under ``no_sync`` and the accumulated mean is averaged once, so the
    update reads the mean of the four samples' single-process gradients
    (clipped), as one step on all four would."""
    ranks = runs["accumulate"]["ranks"]
    assert all(r["global_iter"] == 2 for r in ranks)
    samples = [_shard(r)[i] for r in range(2) for i in range(2)]
    gens = [step_generator(0, i, r) for r in range(2) for i in range(2)]
    ref = _sample_grads("gs25600_solid_tiny", samples, gens)
    # each rank's running mean, then the mean over the ranks
    acc = [{n: ref[2 * r][n] + (ref[2 * r + 1][n] - ref[2 * r][n]) / 2
            for n in ref[0]} for r in range(2)]
    mean = _clipped({n: (acc[0][n] + acc[1][n]) / 2 for n in acc[0]})
    for r in ranks:
        _assert_grads(r["update_grads"], mean)


@pytest.mark.parametrize("run", ["cli_solid", "cli_144k"])
def test_eval_counts_are_summed_over_the_ranks(runs, run):
    """The fit's evaluation and the eval CLI (each rank one of the two val
    samples) report the same counts on every rank: those of one process
    evaluating both samples with rank 0's checkpoint. ``MeanIoU.result``
    with ``distributed`` reads the sum of the ranks' counts."""
    from gaussianformer_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                           load_checkpoint)
    cfg = get_config(RUNS[run][1])
    model = build_segmentor(cfg, device="cpu", seed=None)
    model.load_state_dict(load_checkpoint(
        latest_checkpoint(runs[run]["work"]))["model"])
    metric = MeanIoU()
    ds = build_dataset(cfg, "val", synthetic=True, num_samples=2)
    with torch.inference_mode():
        for i in range(2):
            b = collate([ds[i]])
            out = model(b["imgs"], b["projection_mat"], b["image_wh"],
                        b["occ_xyz"], b["occ_label"], b["occ_cam_mask"],
                        generator=torch.Generator().manual_seed(0))
            metric.update(out["final_occ"], out["sampled_label"],
                          out["occ_mask"])
    assert metric.counts[-1, 0] > 0
    for r in runs[run]["ranks"]:
        np.testing.assert_array_equal(r["fit_counts"], metric.counts)
        np.testing.assert_array_equal(r["eval_counts"], metric.counts)
        # MeanIoU.result(distributed=True) reads the summed (3, 2, 4) rows:
        # IoUs of 0.4, where either rank's own would give 0.5 or 1/3
        summed = np.tile([3, 2, 4], (len(metric.counts), 1))
        assert r["result"] == compute_iou(summed)[:2]
        assert abs(r["result"][0] - 40.0) < 1e-9


@pytest.mark.parametrize("run", ["cli_solid", "accumulate"])
def test_only_rank_zero_writes(runs, run):
    """Rank 0 alone saves the checkpoint and writes ``metrics.jsonl`` (one
    record a step) and ``train.log``; both ranks resume from it."""
    ranks = runs[run]["ranks"]
    assert ranks[0]["saves"] == [2] and ranks[1]["saves"] == []
    work = runs[run]["work"]
    assert sorted(os.listdir(work)) == ["ckpt_000000002.pt", "latest",
                                        "metrics.jsonl", "train.log"]
    assert [r["iter"] for r in runs[run]["metrics"]] == [1, 2]
    assert "rank 0 of 2" in runs[run]["log"]
    assert "rank 1 of 2" not in runs[run]["log"]


if __name__ == "__main__":
    _worker(*sys.argv[1:])
