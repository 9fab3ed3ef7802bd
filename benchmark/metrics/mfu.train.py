"""Share (%) of the bf16 peak of one H100 (989 TFLOP/s, dense) that a
train step reaches: the model's conv and matmul work a step, forward and
backward (from the shapes in work/flops.py), over the traced window's
host time a step."""

PEAK = 989e12


def read(ctx):
    if ctx["loop"] != "train" or not ctx["count"]:
        return None
    w = ctx["work"]
    return 100.0 * (w.forward + w.backward) / (ctx["wall_s"] / ctx["count"]) \
        / PEAK
