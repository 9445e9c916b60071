"""Kernels: the SSD scan's forward ops of the traced prefills, their summed
bounds over their kernels' device time, in percent."""
from portbench.harness import rooflines

OPS = {"repro_torch::ssd_scan_fwd": rooflines.ssd_forward}


def read(run):
    return rooflines.share(run.trace, OPS, run.model) if run.requests else None
