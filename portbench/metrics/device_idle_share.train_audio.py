"""Device: the share of the traced training steps' host seconds in which
no operation ran on the device, in percent.
In the audio encoder's training cells, which report ``train_frames_per_s``."""
from portbench.harness import stats


def read(run):
    if not run.steps or run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * stats.idle_share(run.trace.busy_s, run.trace.window_s)
