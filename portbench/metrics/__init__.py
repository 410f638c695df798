"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``portbench/metrics/<name>.py`` defines ``read(ctx) -> float | None``.

``ctx`` is what one run measured (``portbench/run.py::run_cell`` builds
it): ``setup_s``; ``peak_bytes``; ``shape`` (``b``, ``f``, ``d`` and
``u_mean``, the mean unique ids of a batch of the cached epoch, from the
benchmark's own parse of the lines); ``window`` (``s``, ``steps``,
``examples``, ``dispatches``, and the port's ``train.wait_input`` and
``train.dispatch`` timers over it, ``wait_s`` and ``dispatch_s``); and,
in a ``--trace 1`` run, ``trace`` (the traced slice after the window:
``window_s``, ``busy_s``, ``steps``, ``dispatches``, ``kernel_s`` by
CUDA name).  A
reader that finds nothing to read returns None, and the metric is left
out of the run's line.
"""
