"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the device dispatch between them (``ops.py``)."""
