"""Attention kernels of the port: plain versions (``ref``), CUDA wrappers and
the device-dispatching entry points (``ops``)."""
