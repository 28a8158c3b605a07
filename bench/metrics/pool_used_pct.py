"""Peak pages held over the pool's pages, after each step of the window."""

from bench import readings


def read(rec):
    return readings.pool_used_pct(rec)
