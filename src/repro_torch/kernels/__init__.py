"""Kernels of the port (attention and its gradient, SSD and RG-LRU scans,
burst gather): plain versions (``ref``), CUDA wrappers and the
device-dispatching entry points (``ops``)."""
