"""The 95th percentile, over every request the window completed, of the
time from its arrival to its first token, synchronised (queueing included)."""
from portbench.harness import stats


def read(run):
    return stats.percentile(run.ttft_s, 95) * 1e3 if run.ttft_s else None
