"""Kernels: the SSD scan's forward and backward ops of the traced steps,
their summed bounds over their kernels' device time, in percent."""
from portbench.harness import rooflines

OPS = {"repro_torch::ssd_scan_fwd": rooflines.ssd_forward,
       "repro_torch::ssd_scan_bwd": rooflines.ssd_backward}


def read(run):
    return rooflines.share(run.trace, OPS, run.model) if run.steps else None
