"""Model step: the model FLOP of the window's steps (``work.train_step_flops``:
no recompute) over the window's seconds, as a percent of 989 TFLOP/s."""
from portbench.harness import work


def read(run):
    if not run.steps:
        return None
    t = run.traffic
    flops = work.train_step_flops(run.model, t["global_batch"], t["seq_len"]) * run.steps
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS_BF16
