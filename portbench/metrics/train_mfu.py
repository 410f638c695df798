"""The whole step's required work at the card's peak
(``counts.step_work``) over the wall time of a step in the window (the
window over its steps)."""

from portbench import counts


def read(ctx):
    w, shape = ctx.get("window"), ctx.get("shape")
    if not w or not shape or not w["steps"] or w["s"] <= 0:
        return None
    least, _ = counts.bound(*counts.step_work(
        shape["b"], shape["f"], shape["d"], shape["u_mean"]))
    return 100.0 * least * w["steps"] / w["s"]
