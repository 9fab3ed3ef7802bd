"""The readings that the limits of ``checks/<workload>.json`` are set
from: every number of the comparison (those compared and those only
looked at) for many seeds in one process, with the program, the control
or the reference at the stated precision in the program's place.

    python3 -m benchmark.readings --workload prob64-frame \
        --system program --seconds 2 --seeds 1 2 3 ...
    python3 -m benchmark.readings --workload prob64-train \
        --system control --seeds 1 2 3

``program``: a short window of the cell, then the check, as a run makes
it; with ``--fault``, the program with a fault planted (:data:`FAULTS`). ``control``: the reference one precision step down. ``stated``: the reference at the precision the
configuration states (bf16 towers and spconv), to see how far a number
moves with the precision alone. ``look`` (train cells): where the first
step's gradient comes from (:func:`look`). One JSON line a seed. Needs
the card."""
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


#: faults planted in the program, by name
FAULTS = {"dcn_backward_halved": dcn_backward_halved}


def program(cell, seconds):
    window = loops.find(cell.traffic["loop"])(cell, seconds, False,
                                              time.perf_counter())
    return run.compare(cell, window), window.metrics


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


def look(cell):
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
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload, _ = run.spec(ns.workload)
    for seed in ns.seeds:
        cell = run.make_cell(workload, seed, "cuda")
        t0 = time.perf_counter()
        if ns.system == "program":
            with (FAULTS[ns.fault]() if ns.fault
                  else contextlib.nullcontext()):
                numbers, metrics = program(cell, ns.seconds)
        elif ns.system == "look":
            numbers, metrics = look(cell), {}
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
