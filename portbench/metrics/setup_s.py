"""Process start to the window's opening: imports, the kernel library's
load (and its build in a fresh checkout), the data written, epoch 0
parsed and trained, the capture, the check's snapshots."""


def read(ctx):
    return ctx.get("setup_s")
