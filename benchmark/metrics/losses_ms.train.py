"""Device ms a step of the program's span `step/losses` (the loss stack
on the forward's outputs), from the program-traced stretch after the timed
window (benchmark/program.py)."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "train", "step/losses", "device_ms")
