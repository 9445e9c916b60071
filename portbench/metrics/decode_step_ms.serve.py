"""Entry (decode, host-paced): the median synchronised decode step of the
window, over the live slots."""
import statistics


def read(run):
    return statistics.median(run.decode_s) * 1e3 if run.decode_s else None
