"""Sequences a decode step, over the window's decode steps (the scheduler's
batch)."""

from bench import readings


def read(rec):
    return readings.decode_batch_mean(rec)
