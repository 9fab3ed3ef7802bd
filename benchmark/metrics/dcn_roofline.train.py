"""Share (%) of the bf16 peak of one H100 (989 TFLOP/s, dense) that the
DCNv2 modules of both towers reach in a train step: their operations
forward and backward (three times the forward's, from the shapes in
work/flops.py; every DCN's backward runs) over their summed device time
(CUDA events around each DeformConv2d call and around its backward, from
its output's gradient to its input's)."""

PEAK = 989e12


def read(ctx):
    if ctx["loop"] != "train" or not ctx["spans"].get("dcn"):
        return None
    ops = 3 * sum(ctx["work"].dcn) * ctx["count"]
    return 100.0 * ops / (ctx["spans"]["dcn"] / 1e3) / PEAK
