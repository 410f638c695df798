"""The share of the window the training loop waited for its next
super-batch: the port's ``train.wait_input`` timer over the window."""


def read(ctx):
    w = ctx.get("window")
    return 100.0 * w["wait_s"] / w["s"] if w and w["s"] > 0 else None
