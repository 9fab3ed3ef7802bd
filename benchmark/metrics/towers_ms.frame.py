"""Device ms a frame of the towers span (CUDA events around the module
calls, summed over the traced window, over its frames)."""


def read(ctx):
    if ctx["loop"] != "frame" or "towers" not in ctx["spans"]:
        return None
    return ctx["spans"]["towers"] / ctx["count"]
