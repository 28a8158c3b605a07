"""Decode tokens committed inside the window (by steps that returned in it),
over the window's seconds."""

from bench import readings


def read(rec):
    return readings.output_tok_s(rec)
