"""PyTorch/CUDA port of the ALPHA-PIM reproduction.

Mirrors the JAX package ``repro`` (``core/``, ``kernels/``, ``graphs/``,
the LM stack's ``models/``, ``configs/``, ``serve/``, and training on one
device: ``train/``, ``distributed/``, ``launch/``) and is held
against it by the tests. Plain tensor code is PyTorch; the kernels are
CUDA C++ written for Hopper (``kernels/csrc/``), built with nvcc at first
use. Nothing here imports ``jax`` or ``repro``.
"""
