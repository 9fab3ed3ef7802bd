"""Device ms a frame of the program's span `encoder/spconv` (every
SparseConv3DModule call: voxel lookup, gather, mask and matmuls), from the
program-traced stretch after the timed window (benchmark/program.py)."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "frame", "encoder/spconv", "device_ms")
