"""The readings that the limits of ``checks/<workload>.json`` are set
from: every number of the comparison (those compared and those only
looked at) for many seeds in one process, with the program, the control
or the reference at the stated precision in the program's place.

    python3 -m benchmark.readings --workload prob64-frame \
        --system program --seconds 2 --seeds 1 2 3 ...
    python3 -m benchmark.readings --workload prob64-train \
        --system control --seeds 1 2 3
    python3 -m benchmark.readings --workload gs144k-train --steps 1 \
        --seeds 1 2 3

``--steps``: a train cell's reference follows that many steps (the
change after the first step alone, to see what the later ones add).

``program``: a short window of the cell, then the check, as a run makes
it; with ``--fault``, the program with a fault planted (:data:`FAULTS`). ``control``: the reference one precision step down. ``stated``: the reference at the precision the
configuration states (bf16 towers and spconv), to see how far a number
moves with the precision alone. ``look`` (train cells): where the first
step's gradient comes from, and the spconv's backward beside a second
witness (:func:`look`). One JSON line a seed; with ``program`` its
``metrics`` also hold the check's seconds and the reference's peak
memory. Needs the card."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from . import check, control, run, synth
from . import loops
from .reference.model import Model, TrainStep
from .reference.precision import Precision


@contextlib.contextmanager
def dcn_backward_halved():
    """The program's DCN backward (K5) giving half of each gradient."""
    from gaussianformer_tpu_torch.kernels import dcn
    real = dcn.deform_conv2d_backward
    dcn.deform_conv2d_backward = lambda *a: tuple(
        None if g is None else g * 0.5 for g in real(*a))
    try:
        yield
    finally:
        dcn.deform_conv2d_backward = real


@contextlib.contextmanager
def empty_gaussian_left_out():
    """The program's head splatting without its empty Gaussian (the
    learnt Gaussians keep their zero empty column)."""
    from gaussianformer_tpu_torch.models.head import gaussian_head
    cls = gaussian_head.GaussianHead
    real = cls.prepare_gaussian_args

    def without(self, gaussians):
        args = real(self, gaussians)
        return tuple(a[:, :-1] for a in args) if self.with_empty else args
    cls.prepare_gaussian_args = without
    try:
        yield
    finally:
        cls.prepare_gaussian_args = real


@contextlib.contextmanager
def empty_scalar_grad_zeroed():
    """The program's train step giving its head's ``empty_scalar`` a zero
    gradient."""
    from .loops import train
    real = train.build_program

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        model.head.empty_scalar.register_hook(torch.zeros_like)
        return model
    train.build_program = build
    try:
        yield
    finally:
        train.build_program = real


@contextlib.contextmanager
def spconv_weight_grad_halved():
    """The program's spconv in the gather form (a train step's) giving its
    weight half of its gradient; the forward is unchanged."""
    from gaussianformer_tpu_torch.models.encoder import modules
    cls = modules.SubMConv3d
    real = cls.forward

    def halved(self, x, nb_anchor):
        w = self.weight * 0.5
        return modules.submanifold_conv3d(x, nb_anchor, w + w.detach(),
                                          self.bias, compute_dtype=self.dtype)
    cls.forward = halved
    try:
        yield
    finally:
        cls.forward = real


@contextlib.contextmanager
def bank_update_halved():
    """The program's train step moving its v1 anchor bank
    (``lifter.anchor``) by half of the optimizer's update."""
    from gaussianformer_tpu_torch.train import step
    real = step.train_step

    def halved(model, *args, **kwargs):
        bank = model.lifter.anchor
        keep = bank.detach().clone()
        out = real(model, *args, **kwargs)
        with torch.no_grad():
            bank.copy_(keep + 0.5 * (bank - keep))
        return out
    step.train_step = halved
    try:
        yield
    finally:
        step.train_step = real


#: faults planted in the program, by name
FAULTS = {"dcn_backward_halved": dcn_backward_halved,
          "empty_gaussian_left_out": empty_gaussian_left_out,
          "empty_scalar_grad_zeroed": empty_scalar_grad_zeroed,
          "spconv_weight_grad_halved": spconv_weight_grad_halved,
          "bank_update_halved": bank_update_halved}


def window_and_check(cell, seconds):
    """(the window, the numbers of its check, the check's seconds, the
    check's peak GiB of device memory): a short window of the cell, then
    the check as a run makes it, once the program's state is freed."""
    window = loops.find(cell.traffic["loop"])(cell, seconds, False,
                                              time.perf_counter())
    gc.collect()
    cuda = torch.device(cell.device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    numbers = run.compare(cell, window)
    loops.sync(cell.device)
    return (window, numbers, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None)


def program(cell, seconds):
    window, numbers, check_s, peak_gib = window_and_check(cell, seconds)
    return numbers, dict(window.metrics, check_s=check_s,
                         check_peak_gib=peak_gib)


def _reference(cell, prec=Precision(), checkpoint=False):
    m = Model(cell.c, prec, checkpoint).to(cell.device)
    m.load_state_dict(synth.make_state(cell.shapes, cell.c, cell.seed,
                                       cell.device), strict=True)
    return m


def planted(cell, system):
    """The numbers with ``system`` (``control`` or ``stated``) in the
    program's place, on the cell's inputs of its seed."""
    c, tr, dev = cell.c, cell.traffic, cell.device
    train = tr["loop"] == "train"
    ring = synth.samples(c, tr["ring"], cell.seed, dev, labels=train)
    prec = {"control": Precision.control(),
            "stated": Precision(stated=True)}.get(system, Precision())
    if not train:
        draws = (synth.lifter_draws(c, tr["ring"], cell.seed, dev)
                 if c["version"] == 2 else [None] * tr["ring"])
        sut = _reference(cell, prec)
        cap, labels = control.frame_stages(sut, ring[0], draws[0])
        del sut
        return check.check_frame(_reference(cell), cap, ring[0], draws[0],
                                 labels)
    sut_model = _reference(cell, prec, checkpoint=True)
    sut = control.train_steps(sut_model, ring, synth.generator(
        cell.seed, synth.DROPOUT, dev), tr["schedule_steps"],
        tr["checked"])
    del sut_model
    gc.collect()
    ref = _reference(cell, checkpoint=True)
    return check.check_train(ref, TrainStep(ref, tr["schedule_steps"]),
                             sut, ring)


def look(cell, seconds):
    """:func:`gradient_sources` and :func:`spconv_witness`."""
    return {**gradient_sources(cell), **spconv_witness(cell, seconds)}


def spconv_witness(cell, seconds):
    """The spconv's backward in the program's first step (bf16, the gather
    form under autograd) beside a second witness: the program's own gather
    form in float32, on the same arguments and cotangents.
    ``spconv_grad_rel``: the program against the float32 reference;
    ``spconv_grad_rel_fp32_form``: the float32 gather form against the
    reference (its arithmetic: near 0 if the form is right);
    ``spconv_grad_rel_bf16_vs_fp32_form``: the program against the float32
    gather form (what bf16 alone moves). Each the worst over the spconvs
    whose backward ran (``spconvs_followed``)."""
    from gaussianformer_tpu_torch.models.encoder.modules import (
        SparseConv3DModule)
    window, numbers, _, _ = window_and_check(cell, seconds)
    c, dev = cell.c, cell.device
    grads = window.check["sut"]["grads"]
    del window
    ref = _reference(cell)
    form_vs_ref, bf16_vs_form, seen = 0.0, 0.0, 0
    for i, op in enumerate(ref.encoder.order):
        if op != "spconv" or not check._ran(grads.get(i)):
            continue
        seen += 1
        rec = check.moved(grads[i], dev)
        layer = ref.encoder.layers[i]
        form = SparseConv3DModule(
            c["embed_dims"], c["embed_dims"], c["pc_range"],
            c["spconv_grid_size"], layer.k, torch.float32,
            c["spconv_use_out_proj"], c["spconv_use_multi_layer"]).to(dev)
        form.load_state_dict(layer.state_dict())
        params = dict(form.named_parameters())

        def fp32_form(a):
            return form(a[0], a[1])
        _, gap = check.vjp(fp32_form, rec, params)
        bf16_vs_form = max(bf16_vs_form, gap)
        _, arg_grad, param_grad = check.stage_grads(fp32_form, rec, params)
        witness = dict(rec, arg_grad=arg_grad, param_grad=param_grad)
        _, gap = check.vjp(lambda a, i=i: ref.encoder.run_op(i, a), witness,
                           dict(layer.named_parameters()))
        form_vs_ref = max(form_vs_ref, gap)
    return {"spconv_rel": numbers["spconv_rel"],
            "spconv_grad_rel": numbers["spconv_grad_rel"],
            "spconv_grad_rel_fp32_form": form_vs_ref,
            "spconv_grad_rel_bf16_vs_fp32_form": bf16_vs_form,
            "spconvs_followed": seen}


def gradient_sources(cell):
    """Where the gradient of the first step's loss comes from, in the
    float32 reference: the share of its squared norm at the head's output
    that the 10 and the 100 voxels with the largest take, and the true
    class's probability at the largest."""
    c, dev = cell.c, cell.device
    ring = synth.samples(c, 1, cell.seed, dev, labels=True)
    model = _reference(cell, checkpoint=True)
    drawer = control.Drawer(synth.generator(cell.seed, synth.DROPOUT, dev),
                            dev)
    xyz = (control.lifter_xyz(model, ring[0], drawer.lifter(
        c, ring[0]["imgs"].shape[0]))
           if c["version"] == 2 else None)
    outs = []
    real = model.head.forward

    def keep_outputs(*args, **kwargs):
        res = real(*args, **kwargs)
        for o in res[0]:
            o.retain_grad()
            outs.append(o)
        return res
    model.head.forward = keep_outputs
    with torch.enable_grad():
        loss, _ = model.losses(ring[0], xyz, drawer.rand)
        loss.backward()
    g = outs[-1].grad.reshape(-1, outs[-1].shape[-1]).double()
    per = (g * g).sum(-1)
    top = per.sort(descending=True)
    total = per.sum().item()
    lab = ring[0]["occ_label"].reshape(-1)
    probs = outs[-1].detach().reshape(-1, outs[-1].shape[-1])
    first = top.indices[0]
    return {"grad_norm_at_output": total ** 0.5,
            "top10_share": top.values[:10].sum().item() / total,
            "top100_share": top.values[:100].sum().item() / total,
            "true_prob_at_largest": probs[first, lab[first]].item()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", default="program",
                    choices=("program", "control", "stated", "look"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--steps", type=int,
                    help="train steps the reference follows, in place of "
                    "the cell's")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload, _ = run.spec(ns.workload)
    for seed in ns.seeds:
        cell = run.make_cell(workload, seed, "cuda")
        if ns.steps:
            cell.traffic = dict(cell.traffic, checked=ns.steps)
        t0 = time.perf_counter()
        if ns.system == "program":
            with (FAULTS[ns.fault]() if ns.fault
                  else contextlib.nullcontext()):
                numbers, metrics = program(cell, ns.seconds)
        elif ns.system == "look":
            numbers, metrics = look(cell, ns.seconds), {}
        else:
            numbers, metrics = planted(cell, ns.system), {}
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": ns.workload, "system": ns.system,
                          "fault": ns.fault,
                          "seed": seed, "numbers": numbers,
                          "metrics": metrics,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
