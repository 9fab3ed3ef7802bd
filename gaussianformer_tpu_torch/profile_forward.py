"""Where the time of one prob_gs6400 frame goes on the GPU.

    python -m gaussianformer_tpu_torch.profile_forward [--frames 3]

Runs the full-width forward (random weights from seed 0, the synthetic
flagship batch) and prints:

- per-stage device time from CUDA events recorded around each stage
  module (towers, FPN, lifter, encoder ops by kind, head), averaged over
  ``--frames`` frames after one warm-up frame;
- a ``torch.profiler`` trace of one frame: the device's busy time against
  the frame's CUDA-event time, and the kernels with the most device time.

Every number names the card it ran on. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import subprocess

import torch

from .configs import get_config
from .data.synthetic import synthetic_batch
from .models.segmentor import build_segmentor


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
    ap.add_argument("--frames", type=int, default=3)
    ns = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}")

    cfg = get_config("prob_gs6400")
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")

    def frame(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model(batch["imgs"], batch["projection_mat"],
                     batch["image_wh"], batch["occ_xyz"], generator=gen)

    frame(0)
    torch.cuda.synchronize()

    timer = StageTimer()
    timer.attach(model.img_backbone, "main tower (ResNet-101 + DCN)")
    timer.attach(model.img_neck, "FPN")
    timer.attach(model.lifter, "lifter (total)")
    timer.attach(model.lifter.initialize_backbone,
                 "lifter: initializer tower (ResNet-101 + DCN + SECONDFPN)")
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
    print(f"# frame: {frame_ms:.3f} ms (CUDA events, mean of {ns.frames}, "
          f"stage hooks on)")
    for name, ms in timer.totals(ns.frames).items():
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only (operator rows repeat their kernels' time)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print("# profiler: no device time recorded (not measured)")
        return
    print(f"# profiled frame: {traced_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms; idle share {1 - busy_ms / traced_ms:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        print(f"# kernel {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
