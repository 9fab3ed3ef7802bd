"""Device ms a frame of the head span (CUDA events around the module
calls, summed over the traced window, over its frames)."""


def read(ctx):
    if ctx["loop"] != "frame" or "head" not in ctx["spans"]:
        return None
    return ctx["spans"]["head"] / ctx["count"]
