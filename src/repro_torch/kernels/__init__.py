"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref.py``) and the backend dispatch (``ops.py``).

Nothing here touches ``nvcc``, ``triton`` or the card at import time: a
kernel is built and loaded on its first launch (``_build.py``).
"""
