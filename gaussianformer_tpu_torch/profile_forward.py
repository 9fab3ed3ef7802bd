"""Where the time of one frame, or one train step, of a config goes on the
GPU.

    python -m gaussianformer_tpu_torch.profile_forward \
        [--config prob_gs6400|prob_gs12800|prob_gs25600|gs25600_solid|...]
        [--frames 3] [--train]

Runs the config's full-width forward under inference mode (random weights
from seed 0, the synthetic batch at the config's input size) or, with
``--train``, the full train step (forward with dropout, losses, backward,
clipping, AdamW), and prints:

- per-stage device time from CUDA events recorded around each stage
  module's forward (towers, FPN, lifter, encoder ops by kind, head),
  averaged over ``--frames`` frames or steps after one warm-up; with
  ``--train`` also the backward (from the loss to the last gradient) and
  the optimizer update (norm, clipping, AdamW);
- a ``torch.profiler`` trace of one frame or step: the device's busy time
  against its CUDA-event time, and the kernels with the most device time.

Every number names the card it ran on. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import subprocess

import torch

from .configs import get_config, list_configs
from .data.synthetic import synthetic_batch
from .models.segmentor import build_segmentor
from .train.optim import build_optimizer
from .train.step import apply_gradients, build_loss


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(events):
    """The device-side kernel rows of ``prof.key_averages()`` with device
    time (operator rows repeat their kernels' time, and so do the device
    rows of user annotations such as ``Optimizer.step``)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and _dev_us(e) > 0]


def device_busy_ms(events) -> float:
    """Summed device time of the kernels in ``prof.key_averages()``; 0
    when the profiler recorded none."""
    return sum(_dev_us(e) for e in device_kernels(events)) / 1e3


class StageTimer:
    """CUDA events around module calls, summed per stage name."""

    def __init__(self):
        self.pairs = collections.defaultdict(list)
        self._open = {}

    def attach(self, module, name):
        def pre(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[id(mod)] = ev

        def post(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[name].append((self._open.pop(id(mod)), ev))

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def totals(self, frames: int):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) / frames
                for k, v in self.pairs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="prob_gs6400",
                    choices=list_configs())
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ns = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}; config: {ns.config}")

    cfg = get_config(ns.config)
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")

    phases = collections.defaultdict(float)
    if ns.train:
        opt, schedule = build_optimizer(model, cfg, 10000)
        loss_fn = build_loss(cfg)

    def frame(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if not ns.train:
            with torch.inference_mode():
                return model(batch["imgs"], batch["projection_mat"],
                             batch["image_wh"], batch["occ_xyz"],
                             generator=gen)
        # train.step.train_step, with events between its parts
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.zero_grad(set_to_none=True)
        out = model(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"], batch["occ_label"],
                    batch["occ_cam_mask"], training=True, generator=gen)
        ev[0].record()
        loss, _ = loss_fn(out)
        ev[1].record()
        loss.backward()
        ev[2].record()
        apply_gradients(model, opt, schedule)
        ev[3].record()
        torch.cuda.synchronize()
        for name, i in (("losses", 0), ("backward (loss to gradients)", 1),
                        ("update (norm, clip, AdamW)", 2)):
            phases[name] += ev[i].elapsed_time(ev[i + 1])

    frame(0)
    torch.cuda.synchronize()
    phases.clear()

    timer = StageTimer()
    timer.attach(model.img_backbone, "main tower (ResNet-101 + DCN)")
    timer.attach(model.img_neck, "FPN")
    timer.attach(model.lifter, "lifter (total)")
    if cfg.version == 2:
        timer.attach(model.lifter.initialize_backbone,
                     "lifter: initializer tower (ResNet-101 + DCN + "
                     "SECONDFPN)")
    timer.attach(model.encoder, "encoder (total)")
    for op, layer in zip(model.encoder.operation_order,
                         model.encoder.layers):
        if op not in ("identity", "add"):
            timer.attach(layer, f"encoder: {op}")
    timer.attach(model.head, "head (splat + labels)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(ns.frames):
        frame(1 + i)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / ns.frames
    what = "train step" if ns.train else "frame"
    print(f"# {what}: {frame_ms:.3f} ms (CUDA events, mean of {ns.frames}, "
          f"stage hooks on)")
    print(f"# peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    totals = dict(timer.totals(ns.frames))
    totals.update({k: v / ns.frames for k, v in phases.items()})
    for name, ms in totals.items():
        print(f"# stage {name}: {ms:.3f} ms ({100 * ms / frame_ms:.1f}%)")

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act, acc_events=True) as prof:
        start.record()
        frame(99)
        end.record()
        torch.cuda.synchronize()
    traced_ms = start.elapsed_time(end)
    events = prof.key_averages()
    busy_ms = device_busy_ms(events)
    if busy_ms == 0:
        print("# profiler: no device time recorded (not measured)")
        return
    # the profiler slows the host more than the device (over twice as much
    # in a train step), so the share is given against both windows
    print(f"# profiled {what}: {traced_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms; idle share {1 - busy_ms / traced_ms:.3f} of "
          f"the profiled {what}, {1 - busy_ms / frame_ms:.3f} against the "
          f"unprofiled mean")
    ranked = sorted(device_kernels(events), key=_dev_us, reverse=True)
    # the 30 kernels with the most device time, and the port's own kernels
    # wherever they rank
    own = ("dcn_", "fps_", "deformable_", "splat_")
    for i, e in enumerate(ranked):
        if i < 30 or any(k in e.key for k in own):
            print(f"# kernel {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:110]}")


if __name__ == "__main__":
    main()
