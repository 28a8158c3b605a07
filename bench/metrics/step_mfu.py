"""Model FLOPs of the tokens processed in the traced sub-window over its
seconds at the bf16 peak, in %."""

from bench import readings


def read(rec):
    return readings.mfu(rec)
