"""Device ms a step of the program's span `step/forward` (the train
step's forward), from the program-traced stretch after the timed window
(benchmark/program.py)."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "train", "step/forward", "device_ms")
