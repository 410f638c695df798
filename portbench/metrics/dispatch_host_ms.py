"""Host milliseconds a dispatch (a copy into the graph's input and one
replay of its K steps): the port's ``train.dispatch`` timer, its total
over the window's dispatches divided by their number."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w["dispatches"]:
        return None
    return 1e3 * w["dispatch_s"] / w["dispatches"]
