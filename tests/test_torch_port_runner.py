"""The port's runner layer against the JAX package, on the CPU at tiny
sizes: the mean-IoU counts, the step-decay schedule and gradient
accumulation, the host-drawn supervised layers of ``random_k``, resume,
pretrain loading and the eval loop."""
import dataclasses

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.data import DataLoader as JaxLoader
from gaussianformer_tpu.data import SyntheticOccDataset as JaxSynthetic
from gaussianformer_tpu.metrics import mean_iou as jmiou
from gaussianformer_tpu.train import runner as jrunner
from gaussianformer_tpu.train.optim import build_optimizer as jax_optimizer
from gaussianformer_tpu.train.optim import \
    multistep_schedule as jax_multistep
from gaussianformer_tpu.train.train_state import create_train_state

from gaussianformer_tpu_torch.configs import OptimConfig
from gaussianformer_tpu_torch.data import DataLoader, SyntheticOccDataset
from gaussianformer_tpu_torch.metrics import MeanIoU, compute_iou, iou_counts
from gaussianformer_tpu_torch.train import runner
from gaussianformer_tpu_torch.train.optim import (GradientAccumulation,
                                                  build_optimizer,
                                                  multistep_schedule)
from gaussianformer_tpu_torch.train.runner import Trainer
from gaussianformer_tpu_torch.train.step import (apply_gradients, build_loss,
                                                 train_step)
from gaussianformer_tpu_torch.utils.checkpoint import latest_checkpoint
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import TINY, tiny_pair

CLASSES = list(range(1, 17))


@pytest.mark.parametrize("seed", range(4))
def test_iou_counts_equal_jax(seed):
    """Integer counts exactly, and the mIoU and occupancy IoU from them,
    one sample and accumulated over three."""
    rng = np.random.RandomState(seed)
    metric, jmetric = MeanIoU(), jmiou.MeanIoU()
    for _ in range(3):
        out = rng.randint(0, 18, 4000)
        tgt = np.where(rng.rand(4000) < 0.5, out, rng.randint(0, 18, 4000))
        mask = rng.rand(4000) < 0.8
        got = iou_counts(torch.from_numpy(out), torch.from_numpy(tgt),
                         torch.from_numpy(mask), CLASSES, 17)
        ref = np.asarray(jmiou.iou_counts(jnp.asarray(out), jnp.asarray(tgt),
                                          jnp.asarray(mask), CLASSES, 17))
        assert got.dtype == torch.int64 and got.shape == (17, 3)
        np.testing.assert_array_equal(got.numpy(), ref)
        metric.update(torch.from_numpy(out), torch.from_numpy(tgt),
                      torch.from_numpy(mask))
        jmetric.update(out, tgt, mask)
    np.testing.assert_array_equal(metric.counts, jmetric.counts)
    got, ref = metric.result(), jmetric.result()
    assert got[:2] == ref[:2]
    np.testing.assert_array_equal(got[2], ref[2])
    assert compute_iou(metric.counts)[:2] == jmiou.compute_iou(
        jmetric.counts)[:2]
    with pytest.raises(NotImplementedError, match="DDP"):
        metric.result(distributed=True)


def test_multistep_schedule_matches_jax():
    for milestones in ((5, 12, 20), (3,)):
        sched = multistep_schedule(4e-4, milestones, warmup_steps=4)
        jsched = jax_multistep(4e-4, milestones, warmup_steps=4)
        for step in range(30):
            np.testing.assert_allclose(sched(step), float(jsched(step)),
                                       rtol=1e-6)


class Toy(nn.Module):
    """Parameters named as the segmentor's: a frozen stem, a backbone stage
    (lr x 0.1) and a head (the default group)."""

    def __init__(self):
        super().__init__()
        self.img_backbone = nn.ModuleDict({"conv1": nn.Linear(3, 4),
                                           "layer2": nn.Linear(4, 5)})
        self.head = nn.Linear(5, 2)


JAX_NAMES = {"img_backbone.conv1": "img_backbone/conv1",
             "img_backbone.layer2": "img_backbone/stage2", "head": "head"}


def _jax_tree(named):
    tree = {}
    for name, val in named.items():
        mod, leaf = name.rsplit(".", 1)
        path = JAX_NAMES[mod].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(val)
    return tree


def _flat(tree):
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        mod = {v: k for k, v in JAX_NAMES.items()}["/".join(keys[:-1])]
        out[f"{mod}.{keys[-1]}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("milestones", [None, (3,)])
def test_accumulation_matches_optax_multisteps(milestones):
    """k = 2 over 8 micro-steps: the parameters after every micro-step
    against optax.MultiSteps around the JAX package's clipped AdamW (the
    gradients' norm crosses the clip at 35)."""
    cfg = dataclasses.replace(TINY, freeze_lifter=False, optim=OptimConfig(
        warmup_iters=2))
    model = Toy()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, schedule = build_optimizer(model, cfg, 10, milestones=milestones)
    acc = GradientAccumulation(2)
    params = _jax_tree({n: t.numpy() for n, t in start.items()})
    tx, _ = jax_optimizer(params, cfg.optim.lr, 10, warmup_steps=2,
                          frozen_prefixes=("img_backbone/conv1",),
                          grad_accumulation=2, milestones=milestones)
    state = tx.init(params)
    rng = np.random.RandomState(0)
    for step in range(8):
        scale = 30.0 if step % 3 else 0.5
        grads = {n: (rng.randn(*p.shape) * scale).astype(np.float32)
                 for n, p in start.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        if acc.add(model):
            apply_gradients(model, opt, schedule)
        updates, state = tx.update(_jax_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
        ref = _flat(params)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0,
                                       atol=1e-6, err_msg=f"{step} {n}")
    moved = {n: not torch.equal(p.detach(), start[n])
             for n, p in model.named_parameters()}
    assert moved == {n: not n.startswith("img_backbone.conv1")
                     for n in moved}


def random_k_cfg(k=3, decoders=4):
    return dataclasses.replace(TINY, num_decoder=decoders,
                               apply_loss_type=f"random_{k}",
                               optim=OptimConfig(max_epochs=2))


@pytest.mark.parametrize("seed", [0, 7])
def test_draw_loss_layers_matches_jax(tmp_path, seed):
    cfg = random_k_cfg()
    jcfg = dataclasses.replace(jax_get_config("prob_gs6400"),
                               apply_loss_type="random_3")
    port = Trainer(cfg, None, None, str(tmp_path), seed=seed, device="cpu")
    ref = jrunner.Trainer(jcfg, None, None, str(tmp_path), seed=seed,
                          use_mesh=False)
    draws = set()
    for it in range(20):
        port.global_iter = ref.global_iter = it
        layers = port._draw_loss_layers()
        assert layers == ref._draw_loss_layers()
        draws.add(layers)
    assert len(draws) > 1


def synthetic_loader(cfg, n, seed=0, shuffle=True):
    g = cfg.grid
    ds = SyntheticOccDataset(n, cfg.num_cams, cfg.input_size,
                             (g.H, g.W, g.D), seed=seed)
    return DataLoader(ds, 1, shuffle=shuffle, seed=3)


def test_random_3_train_step_runs(tmp_path):
    """The repair: ``train_step`` passes the host-drawn layers to the
    model, so a random_3 config trains; without them the head raises."""
    cfg = random_k_cfg(3, decoders=3)
    trainer = Trainer(cfg, synthetic_loader(cfg, 1), None, str(tmp_path),
                      print_freq=1, device="cpu")
    trainer.init_state()
    batch = next(iter(trainer.train_loader))
    with pytest.raises(ValueError, match="apply_loss_layers"):
        train_step(trainer.model, trainer.optimizer, trainer.schedule,
                   build_loss(cfg), batch, torch.Generator().manual_seed(0))
    layers = trainer._draw_loss_layers()
    assert len(layers) == 3
    metrics = train_step(trainer.model, trainer.optimizer, trainer.schedule,
                         build_loss(cfg), batch,
                         torch.Generator().manual_seed(0), layers)
    assert all(torch.isfinite(v) for v in metrics.values())
    trainer.fit()
    assert trainer.global_iter == cfg.optim.max_epochs
    assert latest_checkpoint(str(tmp_path)).endswith(
        f"ckpt_{cfg.optim.max_epochs:09d}.pt")


class Interrupted(Exception):
    pass


@pytest.fixture
def one_thread():
    """Bit-equal runs on the CPU need one intra-op thread: with several,
    two identical tiny fits already differ in the last bits (the
    backward's sums split by thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accumulate,cut", [(1, 2), (2, 1)])
def test_resume_is_bit_equal(tmp_path, monkeypatch, one_thread, accumulate,
                             cut):
    """Three steps in one go against ``cut`` steps, the mid-epoch
    checkpoint, an interruption and a resume in a new Trainer: the same
    samples in the same order, and to the bit the same parameters,
    optimizer state (and accumulated gradients), counters. Dropout is on,
    so the steps' generators must match too."""
    cfg = dataclasses.replace(TINY, optim=OptimConfig(warmup_iters=2,
                                                      max_epochs=1))
    seen = []

    def recording_step(model, opt, sched, loss_fn, batch, *args):
        seen.append(int(batch["occ_label"].sum()))
        return train_step(model, opt, sched, loss_fn, batch, *args)

    monkeypatch.setattr(runner, "train_step", recording_step)
    monkeypatch.setattr(runner, "ITER_CKPT_EVERY", cut)

    def trainer(work_dir):
        return Trainer(cfg, synthetic_loader(cfg, 3), None,
                       str(tmp_path / work_dir), print_freq=1,
                       grad_accumulation=accumulate, iter_resume=True,
                       device="cpu")

    whole = trainer("whole")
    whole.fit()
    order, seen[:] = list(seen), []

    first = trainer("cut")
    save = first.save

    def save_then_stop(last_iter=0):
        save(last_iter)
        if last_iter:
            raise Interrupted
    first.save = save_then_stop
    with pytest.raises(Interrupted):
        first.fit()
    assert seen == order[:cut]
    assert latest_checkpoint(str(tmp_path / "cut")).endswith(
        f"ckpt_{cut:09d}.pt")
    resumed = trainer("cut")
    resumed.init_state()
    assert resumed.try_resume()
    assert (resumed.epoch, resumed.global_iter) == (0, cut)
    resumed.fit()
    assert seen == order
    assert (resumed.epoch, resumed.global_iter) == (whole.epoch,
                                                    whole.global_iter) == (1, 3)
    for (n, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for key, v in sa["state"][k].items():
            assert torch.equal(v, sb["state"][k][key]), (k, key)
    if accumulate > 1:
        assert whole.accumulation.mini_step == resumed.accumulation.mini_step
        for n, v in whole.accumulation.acc.items():
            assert torch.equal(v, resumed.accumulation.acc[n]), n


def _write_pretrains(tmp_path, port_sd):
    """Reference-named checkpoints with random tensors of the model's
    shapes: a backbone file (``backbone.*`` + ``img_neck.*``, a detection
    head and ``num_batches_tracked`` the model has no place for) and a
    lifter initializer file (its anchor and instance features dropped)."""
    rng = np.random.RandomState(11)

    def rand(name, t):
        v = rng.randn(*t.shape).astype(np.float32) * 0.1
        return torch.from_numpy(np.abs(v) + 0.5 if name.endswith(
            "running_var") else v)

    pre = "lifter.initialize_backbone."
    backbone = {("backbone." + k[len("img_backbone."):]
                 if k.startswith("img_backbone.") else k): rand(k, t)
                for k, t in port_sd.items()
                if k.startswith(("img_backbone.", "img_neck."))}
    backbone["backbone.bn1.num_batches_tracked"] = torch.tensor(5)
    backbone["bbox_head.cls.weight"] = torch.zeros(3, 4)
    init = {k[len(pre):]: rand(k, t) for k, t in port_sd.items()
            if k.startswith(pre)}
    init["anchor"] = torch.zeros(4, 25)
    init["instance_feature"] = torch.zeros(4, 8)
    torch.save({"state_dict": backbone}, tmp_path / "backbone.pth")
    torch.save({"state_dict": init}, tmp_path / "init.pth")
    return str(tmp_path / "backbone.pth"), str(tmp_path / "init.pth")


def _jax_trainer(jmodel, variables, work_dir, val_loader=None):
    t = jrunner.Trainer(jax_get_config("prob_gs6400"), None, val_loader,
                        work_dir, use_mesh=False)
    t.model = jmodel
    t._state = create_train_state(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, optax.identity())
    t._make_steps()
    return t


def test_load_torch_pretrained_matches_jax(tmp_path):
    """The same two reference-named pretrains loaded by both runners give
    the same weights, every tensor of the model compared."""
    jmodel, variables, port, _ = tiny_pair(seed=2)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    bb, init = _write_pretrains(tmp_path, before)
    trainer = Trainer(TINY, None, None, str(tmp_path), device="cpu")
    trainer.model = port
    trainer.load_torch_pretrained(bb, init)
    jt = _jax_trainer(jmodel, variables, str(tmp_path))
    jt.load_torch_pretrained(bb, init, check_margin=False)
    ref = jax_to_state_dict({"params": jt._state.params,
                             "batch_stats": jt._state.batch_stats})
    got = port.state_dict()
    assert set(got) == set(ref)
    changed = 0
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
        changed += not torch.equal(got[k], before[k])
    loaded = [k for k in got if k.startswith(("img_backbone.", "img_neck.",
                                              "lifter.initialize_backbone."))]
    assert changed == len(loaded) > 0
    with pytest.raises(ValueError, match="none of its tensors"):
        trainer.load_torch_pretrained(lifter_init_path=bb)


def test_evaluate_matches_jax(tmp_path):
    """Two synthetic val samples through both runners' eval loops with one
    set of weights (the tiny slice of test_torch_port_model: no random
    draw in either forward): equal mIoU and occupancy IoU."""
    jmodel, variables, port, _ = tiny_pair()
    g = TINY.grid
    grid = (g.H, g.W, g.D)
    val = DataLoader(SyntheticOccDataset(2, 6, TINY.input_size, grid,
                                         seed=1), 1)
    jval = JaxLoader(JaxSynthetic(2, 6, TINY.input_size, grid, seed=1), 1)
    trainer = Trainer(TINY, None, val, str(tmp_path), device="cpu")
    trainer.model = port
    got = trainer.evaluate()
    ref = _jax_trainer(jmodel, variables, str(tmp_path), jval).evaluate()
    assert trainer.last_counts.sum() > 0
    assert got == ref
