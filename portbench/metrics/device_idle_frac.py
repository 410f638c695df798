"""The share of the time in which no operation ran on the device: 1 -
the device's busy time a dispatch (the union of its intervals in the
traced slice, over the slice's dispatches) over the wall time a dispatch
of the untraced window.  The profiler slows the host and not the device,
so the slice's own wall time would count its overhead as idle."""


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("window")
    if not t or not w or t["busy_s"] <= 0 or not t["dispatches"] \
            or not w["dispatches"] or w["s"] <= 0:
        return None
    busy = t["busy_s"] / t["dispatches"]
    return 100.0 * (1.0 - busy / (w["s"] / w["dispatches"]))
