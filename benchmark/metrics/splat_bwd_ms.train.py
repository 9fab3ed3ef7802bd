"""Device ms a step of the program's span `splat_bwd` (each call of the
splat's backward, K7: the tile launch and the fold, the empty Gaussian's
slot in every tile included), from the program-traced stretch after the
timed window (benchmark/program.py). None where the program has no such
span."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "train", "splat_bwd", "device_ms")
