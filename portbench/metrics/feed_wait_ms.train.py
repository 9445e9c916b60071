"""Dataplane: the mean, over the window's steps, of the time a step waits
for its batch from the feed (the trainer's ``feed_times_s`` counter)."""
import statistics


def read(run):
    return statistics.fmean(run.feed_s) * 1e3 if run.feed_s else None
