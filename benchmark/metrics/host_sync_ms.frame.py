"""Host ms a frame in the program's host reads of device values (its
`sync/*` spans, each a wait for the device), from the program-traced
stretch after the timed window (benchmark/program.py)."""
from benchmark.program import sync_host_ms


def read(ctx):
    return sync_host_ms(ctx, "frame")
