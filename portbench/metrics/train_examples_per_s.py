"""Examples trained in the window over the window's whole time."""


def read(ctx):
    w = ctx.get("window")
    return w["examples"] / w["s"] if w and w["s"] > 0 else None
