"""Host ms a step of the program's span `step/update` (AdamW's step, as
long as the host spends in it; its device time is update_ms.train), from
the program-traced stretch after the timed window (benchmark/program.py)."""
from benchmark.program import per_call


def read(ctx):
    return per_call(ctx, "train", "step/update", "host_ms")
