"""fast_tffm_tpu_torch: the PyTorch/CUDA port of fast_tffm_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It imports
torch and numpy only, never jax or the JAX package.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the GPU the FM
interaction, its backward and the sparse optimizer apply run
hand-written CUDA kernels (``ops/csrc``), on the CPU their plain
PyTorch versions.

``python -m fast_tffm_tpu_torch.cli train|predict|serve <cfg>``:
training (``train/loop.py``: the sparse step on one device or a rank
mesh, the dense optax path on one device), offline predict and a
single-replica scoring server (``serve/server.py``).  What is not
ported yet is in ROADMAP.md's port queue.
"""
