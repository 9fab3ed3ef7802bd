"""Where the time of one frame, or one train step, of a config goes on the
GPU.

    python -m gaussianformer_tpu_torch.profile_forward \
        [--config prob_gs6400|prob_gs12800|prob_gs25600|gs25600_solid|...]
        [--frames 3] [--train] [--chrome-trace PATH]

Runs the config's full-width forward under inference mode (random weights
from seed 0, the synthetic batch at the config's input size) or, with
``--train``, the full train step (``train.step.train_step``: forward with
dropout, losses, backward, clipping, AdamW), and prints:

- the program's spans (``utils/profiling.py``) over ``--frames`` frames or
  steps after one warm-up, a frame's or step's share: device time, self
  device time (less the spans inside), host time and calls, for the
  towers, the lifter and its tower and FPS, the encoder and its spconv
  and deformable aggregation, the head and its binning and splat, every
  DCN and, with ``--train``, the step's forward, losses, backward (each
  DCN's K5), clipping and update; then the program's counters and its
  host reads (``sync/*``);
- a ``torch.profiler`` trace of one frame or step, the program's spans on:
  the device's busy time against its CUDA-event time, and the kernels with
  the most device time; ``--chrome-trace`` writes its timeline, on which
  the spans are ``gf/<name>`` ranges.

Every number names the card it ran on. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from .configs import get_config, list_configs
from .data.synthetic import synthetic_batch
from .models.segmentor import build_segmentor
from .train.optim import build_optimizer
from .train.step import build_loss, train_step
from .utils import profiling


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="prob_gs6400",
                    choices=list_configs())
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--chrome-trace", metavar="PATH",
                    help="write the profiled frame or step's timeline, with "
                         "the program's spans, as a Chrome trace")
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
        return train_step(model, opt, schedule, loss_fn, batch, gen)

    frame(0)
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    profiling.enable()
    start.record()
    for i in range(ns.frames):
        frame(1 + i)
    end.record()
    profiling.disable()
    stats = profiling.collect()
    frame_ms = start.elapsed_time(end) / ns.frames
    what = "train step" if ns.train else "frame"
    print(f"# {what}: {frame_ms:.3f} ms (CUDA events, mean of {ns.frames}, "
          f"the program's spans on)")
    print(f"# peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, sp in stats["spans"].items():
        ms = sp["device_ms"] / ns.frames
        print(f"# span {name}: {ms:.3f} ms ({100 * ms / frame_ms:.1f}%), "
              f"self {sp['self_device_ms'] / ns.frames:.3f} ms, host "
              f"{sp['host_ms'] / ns.frames:.3f} ms, "
              f"x{sp['calls'] / ns.frames:g}")
    for name, v in stats["counters"].items():
        print(f"# counter {name}: {v / ns.frames:g} a {what}")

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    profiling.enable()
    with torch.profiler.profile(activities=act, acc_events=True) as prof:
        start.record()
        frame(99)
        end.record()
        torch.cuda.synchronize()
    profiling.disable()
    traced_ms = start.elapsed_time(end)
    if ns.chrome_trace:
        prof.export_chrome_trace(ns.chrome_trace)
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
