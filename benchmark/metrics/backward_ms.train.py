"""Device ms a step from the end of the losses to the start of AdamW's
step: the backward, the global gradient norm and the clipping."""


def read(ctx):
    if ctx["loop"] != "train" or "backward" not in ctx["spans"]:
        return None
    return ctx["spans"]["backward"] / ctx["count"]
