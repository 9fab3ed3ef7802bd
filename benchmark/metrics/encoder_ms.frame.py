"""Device ms a frame of the encoder span (CUDA events around the module
calls, summed over the traced window, over its frames)."""


def read(ctx):
    if ctx["loop"] != "frame" or "encoder" not in ctx["spans"]:
        return None
    return ctx["spans"]["encoder"] / ctx["count"]
