"""Hand-written Hopper kernels (``csrc/``), their wrappers, the nvcc
build (``_build.py``), the plain PyTorch versions (``ref.py``) and the
front door (``ops.py``)."""
