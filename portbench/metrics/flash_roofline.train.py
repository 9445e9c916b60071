"""Kernels: flash attention's forward and backward ops of the traced steps,
their summed bounds over their kernels' device time, in percent."""
from portbench.harness import rooflines

OPS = {"repro_torch::flash_attention_fwd": rooflines.flash_forward,
       "repro_torch::flash_attention_bwd": rooflines.flash_backward}


def read(run):
    return rooflines.share(run.trace, OPS, run.model) if run.steps else None
