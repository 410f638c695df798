"""Guards of the port's boundaries: it never imports jax, ml_dtypes or
the JAX package (the training, multi-rank, probe and table-format
slices' modules included), its parse workers' import chain imports no
torch, it runs on the GPU unless asked for the CPU, and its kernel
wrappers raise instead of falling back."""

import os
import subprocess
import sys

import pytest
import torch

from fast_tffm_tpu_torch.ops import fm_kernels
from fast_tffm_tpu_torch.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import fast_tffm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "ml_dtypes")
             or m == "fast_tffm_tpu" or m.startswith("fast_tffm_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# The training slices' modules, each of which must be among those loaded.
_TRAIN_SLICE = (
    "fast_tffm_tpu_torch.train.loop", "fast_tffm_tpu_torch.train.sparse",
    "fast_tffm_tpu_torch.train.metrics", "fast_tffm_tpu_torch.ops.sparse_apply",
    "fast_tffm_tpu_torch.data.pipeline", "fast_tffm_tpu_torch.parallel.mesh",
    "fast_tffm_tpu_torch.train.dist", "fast_tffm_tpu_torch.train.shardmap_step",
    "fast_tffm_tpu_torch.data.native", "fast_tffm_tpu_torch.data.prefetch",
    "fast_tffm_tpu_torch.data.queues", "fast_tffm_tpu_torch.tools.ingest_bench",
    "fast_tffm_tpu_torch.data.procpool",
)
# The table-layout probe's modules.
_PROBE_SLICE = (
    "fast_tffm_tpu_torch.tools.timing", "fast_tffm_tpu_torch.tools.micro_probe",
)
# The quantized and tiered-overlay serving slice's modules.
_TABLE_FORMATS_SLICE = (
    "fast_tffm_tpu_torch.ops.quant", "fast_tffm_tpu_torch.train.tiered",
    "fast_tffm_tpu_torch.train.checkpoint", "fast_tffm_tpu_torch.serve.scorer",
    "fast_tffm_tpu_torch.tools.convert_checkpoint",
    "fast_tffm_tpu_torch.weights",
)


def test_port_imports_no_jax_and_no_jax_package():
    # A fresh interpreter: this test process already imported jax
    # through conftest.py, which would hide the check.
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout.splitlines()
    assert int(out[0]) >= 20, out  # every module of the package imported
    assert out[1] == "", f"the port imported {out[1]}"
    loaded = set(out[2].split(","))
    want = set(_TRAIN_SLICE + _PROBE_SLICE + _TABLE_FORMATS_SLICE)
    assert want <= loaded, sorted(want - loaded)


def test_the_parse_workers_import_chain_is_torch_free():
    """What a spawned parse worker imports (``data/procpool.py`` and, in
    the worker, ``data/pipeline.py``) pulls in neither torch nor jax."""
    code = ("import sys; import fast_tffm_tpu_torch.data.procpool; "
            "import fast_tffm_tpu_torch.data.pipeline; print(sorted({"
            "m.split('.')[0] for m in sys.modules} & {'torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]", out


def test_resolve_device_defaults_to_the_gpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("rows, vals, err", [
    (torch.zeros((4, 3, 5), dtype=torch.float64), torch.zeros((4, 3)),
     TypeError),
    (torch.zeros((4, 3, 5)), torch.zeros((4, 3), dtype=torch.float16),
     TypeError),
    (torch.zeros((4, 15)), torch.zeros((4, 3)), ValueError),
    (torch.zeros((4, 3, 5)), torch.zeros((4, 2)), ValueError),
    (torch.zeros((4, 3, 5)), torch.zeros((4, 3)).t().contiguous().t(),
     ValueError),
    (torch.zeros((4, 3, 5)), torch.zeros((4, 3), device="meta"),
     ValueError),
])
def test_kernel_wrapper_raises_instead_of_falling_back(rows, vals, err):
    """The wrapper checks CPU tensors as it checks CUDA ones: what the
    kernel would refuse raises here too, and never counts a launch."""
    before = fm_kernels.fm_scores_cuda.launches
    with pytest.raises(err):
        fm_kernels.fm_scores_cuda(rows, vals)
    assert fm_kernels.fm_scores_cuda.launches == before


@pytest.mark.parametrize("which, bad, err", [
    (2, torch.zeros((4, 4), dtype=torch.float64), TypeError),
    (3, torch.zeros((4,), dtype=torch.float16), TypeError),
    (2, torch.zeros((4, 5)), ValueError),
    (3, torch.zeros((3,)), ValueError),
    (3, torch.zeros((8,))[::2], ValueError),  # not contiguous
    (2, torch.zeros((4, 4), device="meta"), ValueError),
])
def test_fm_grad_wrapper_raises_instead_of_falling_back(which, bad, err):
    args = [torch.zeros((4, 3, 5)), torch.zeros((4, 3)),
            torch.zeros((4, 4)), torch.zeros((4,))]
    args[which] = bad
    before = fm_kernels.fm_grad_cuda.launches
    with pytest.raises(err):
        fm_kernels.fm_grad_cuda(*args)
    assert fm_kernels.fm_grad_cuda.launches == before
