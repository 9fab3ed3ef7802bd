"""Share (%) of the bf16 peak of one H100 (989 TFLOP/s, dense) that the
DCNv2 modules of both towers reach in a frame: their operations (offset
conv and deformable 3x3, from the shapes in work/flops.py) over their
summed device time (CUDA events around each DeformConv2d call)."""

PEAK = 989e12


def read(ctx):
    if ctx["loop"] != "frame" or not ctx["spans"].get("dcn"):
        return None
    ops = sum(ctx["work"].dcn) * ctx["count"]
    return 100.0 * ops / (ctx["spans"]["dcn"] / 1e3) / PEAK
