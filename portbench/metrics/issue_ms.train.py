"""Entry layer: the mean, over the window's steps, of the host time the
trainer takes to issue a step's work (its ``issue_times_s`` counter)."""
import statistics


def read(run):
    return statistics.fmean(run.issue_s) * 1e3 if run.issue_s else None
