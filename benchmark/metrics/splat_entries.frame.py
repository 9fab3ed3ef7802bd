"""Gaussian-tile entries a frame of the splat's bins (the program's
counter `splat_entries`, each binning's total, summed on the card), from
the program-traced stretch after the timed window (benchmark/program.py)."""
from benchmark.program import stats


def read(ctx):
    if ctx["loop"] != "frame":
        return None
    p = stats(ctx)
    if p is None or "splat_entries" not in p["counters"]:
        return None
    return p["counters"]["splat_entries"] / p["count"]
