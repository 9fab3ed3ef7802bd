"""Share (%) of the bf16 peak of one H100 (989 TFLOP/s, dense) that a
frame reaches: the model's conv and matmul work a frame (from the shapes
in work/flops.py) over the traced window's host time a frame."""

PEAK = 989e12


def read(ctx):
    if ctx["loop"] != "frame" or not ctx["count"]:
        return None
    return 100.0 * ctx["work"].forward / (ctx["wall_s"] / ctx["count"]) \
        / PEAK
