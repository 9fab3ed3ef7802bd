"""Device ms a frame of the lifter span (CUDA events around the module
calls, summed over the traced window, over its frames)."""


def read(ctx):
    if ctx["loop"] != "frame" or "lifter" not in ctx["spans"]:
        return None
    return ctx["spans"]["lifter"] / ctx["count"]
