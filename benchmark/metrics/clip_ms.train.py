"""Device ms a step of the program's span `step/clip` (the global
gradient norm, the clipping and the lr set), from the program-traced
stretch after the timed window (benchmark/program.py)."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "train", "step/clip", "device_ms")
