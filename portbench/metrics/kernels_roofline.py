"""The least time the bytes and float32 operations of FmScorer, FmGrad,
K1 and K2 take at the card's peaks (``counts.kernel_work``), over their
summed device time in the traced slice."""

from portbench import counts


def read(ctx):
    t, shape = ctx.get("trace"), ctx.get("shape")
    if not t or not shape:
        return None
    spent = sum(t["kernel_s"].get(name, 0.0) for name in counts.KERNELS)
    if spent <= 0 or not all(t["kernel_s"].get(n) for n in counts.KERNELS):
        return None
    least, _ = counts.bound(*counts.kernel_work(
        shape["b"], shape["f"], shape["d"], shape["u_mean"]))
    return 100.0 * least * t["steps"] / spent
