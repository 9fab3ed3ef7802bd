"""Share (%) of a frame in which no operation ran on the device:
1 - busy / wall, busy a frame's share of the union of the device
operations' intervals in the profiler's stretch at the end of the traced
run, wall a frame's host time in the traced window before it (the profiler
itself slows the host). Not measured (no value) where the profiler
recorded no device operation."""


def read(ctx):
    p = ctx["profile"]
    if ctx["loop"] != "frame" or not p.get("busy_s") or not ctx["count"]:
        return None
    busy = p["busy_s"] / p["count"]
    return 100.0 * (1.0 - busy / (ctx["wall_s"] / ctx["count"]))
