"""PyTorch / CUDA port of two_tower_models_tpu.

The JAX package beside it is the reference; this package imports nothing of
it and no JAX.  Entry points (``models.two_tower.init_params``,
``models.two_tower.retrieve``, ``serving.RetrievalEngine``) run on CUDA
unless the caller passes ``device="cpu"``; the CUDA kernels under
``csrc/`` are built with ``nvcc`` on first use (``ops/_lib.py``).
"""
