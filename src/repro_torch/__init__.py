"""PyTorch/CUDA port of the ``repro`` model-serving path for NVIDIA Hopper.

The package mirrors ``repro``'s module names so each module has an obvious
counterpart, keeps the JAX parameter layouts and key names at its public
functions, and imports nothing from ``repro``: what it needs from there it
keeps as its own copy.

Attention and the SSD and RG-LRU scans run through four CUDA C++ kernels
written for ``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first use.
Every kernel entry point picks its path from the tensor's device: a CPU
tensor takes the plain PyTorch version, a CUDA tensor takes the kernel, any
other device raises.
"""
