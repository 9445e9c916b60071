"""The 95th percentile, over every request the window completed, of its
time per output token: from its first token to its last, over the tokens
after the first, synchronised."""
from portbench.harness import stats


def read(run):
    return stats.percentile(run.tpot_s, 95) * 1e3 if run.tpot_s else None
