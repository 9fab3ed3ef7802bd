"""Device ms a step of AdamW's step (its step pre- and post-hooks)."""


def read(ctx):
    if ctx["loop"] != "train" or "update" not in ctx["spans"]:
        return None
    return ctx["spans"]["update"] / ctx["count"]
