"""Shared helpers of the benchmark's tests: a cell shrunk to a size the
CPU runs in seconds."""

import pytest

from portbench import run

# V, B and the cached epoch cut down; every width of the cell kept.
TINY = {"General": {"vocabulary_size": "4096"},
        "Train": {"batch_size": "64", "shuffle_buffer": "200",
                  "thread_num": "2"},
        "epoch_lines": 8 * 64}
CELLS = ("criteo_kaggle.cached_zipf", "avazu.cached_zipf")
SEED = 2**31 + 977


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, device="cpu", **kw)``: ``run.run_cell`` at
    :data:`TINY` with a 0.2 s window."""
    def go(cell, device="cpu", seed=SEED, trace=False, **kw):
        return run.run_cell(run.load_cell(cell), seed, 0.2, trace, device,
                            dict(TINY), **kw)
    return go
