"""Model step: the model FLOP of the window's prefills
(``work.prefill_flops``) over their seconds to the first token, as a
percent of 989 TFLOP/s."""
from portbench.harness import work


def read(run):
    if not run.prefill_s:
        return None
    flops = sum(work.prefill_flops(run.model, run.batch, P) for P in run.prefill_lens)
    return 100.0 * flops / sum(run.prefill_s) / work.PEAK_FLOPS_BF16
