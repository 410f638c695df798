"""Device milliseconds a step: the union of the device's intervals in the
traced slice over its steps."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
