"""p95 over every request with two tokens or more in the window of (last -
first token time) / (tokens - 1), its tokens in the window."""

from bench import readings


def read(rec):
    return readings.tpot_ms(rec, 95)
