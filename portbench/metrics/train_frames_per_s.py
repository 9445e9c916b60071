"""Audio frames of all the window's training steps (an encoder's input
positions) over the window's seconds."""
from portbench.harness import stats


def read(run):
    return stats.rate(run.tokens, run.window_s) if run.tokens else None
