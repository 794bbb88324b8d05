"""PyTorch/CUDA port of the DSA serving system (``repro`` is the JAX reference).

The layout mirrors ``repro``: ``repro/X/y.py`` maps to ``repro_torch/X/y.py``.
The package imports torch, numpy and the standard library only; its two
attention kernels are CUDA C++ for Hopper (``kernels/csrc``), built with
nvcc at first use and bound through ctypes.
"""
