"""Model step: device ms a traced step of ATen's elementwise, fill, add and
copy kernels (by name part, ``trace.ELEMENTWISE_PARTS``).
In the audio encoder's training cells, which report ``train_frames_per_s``."""


def read(run):
    if not run.steps or run.trace is None or not run.trace.busy_s:
        return None
    return run.trace.elementwise_s() / run.trace.units * 1e3
