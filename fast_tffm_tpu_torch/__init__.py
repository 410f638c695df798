"""fast_tffm_tpu_torch: the PyTorch/CUDA port of fast_tffm_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It imports
torch and numpy only, never jax or the JAX package.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the GPU the FM
interaction runs a hand-written CUDA kernel (``ops/csrc``), on the CPU
its plain PyTorch version.

This slice serves: ``python -m fast_tffm_tpu_torch.cli serve <cfg>``
(see ``serve/server.py``).  Training and offline predict come later
(ROADMAP.md, port queue).
"""
