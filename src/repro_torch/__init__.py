"""PyTorch/CUDA port of ``repro``'s model serving and bypass-fed training for
NVIDIA Hopper.

The package mirrors ``repro``'s module names so each module has an obvious
counterpart, keeps the JAX parameter layouts and key names at its public
functions, and imports nothing from ``repro``: what it needs from there it
keeps as its own copy.

Attention (forward and backward), the SSD and RG-LRU scans and the packet
burst gather run through CUDA C++ kernels written for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use.
Every kernel entry point picks its path from the tensor's device: a CPU
tensor takes the plain PyTorch version, a CUDA tensor takes the kernel, any
other device raises.
"""
