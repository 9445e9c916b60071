"""Kernels of the port (attention, SSD and RG-LRU scans): plain versions
(``ref``), CUDA wrappers and the device-dispatching entry points (``ops``)."""
