"""Prefill launches of the paged walk: the sum of each launch's least time over
the sum of their device times, in %."""

from bench import readings


def read(rec):
    return readings.roofline(rec, "paged.prefill")
