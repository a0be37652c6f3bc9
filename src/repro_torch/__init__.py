"""PyTorch/CUDA port of the FQ-BERT integer serving stack.

Mirrors the reference package ``repro`` module for module (``configs``,
``core``, ``kernels``, ``models``, ``serve``, ``launch``) and never
imports it or JAX.  Plain tensor code is PyTorch; every TPU kernel on the
serving path is a CUDA kernel for Hopper (``csrc/``), built with ``nvcc``
on first use (``kernels/_build.py``) and bound through ``ctypes``.
"""
