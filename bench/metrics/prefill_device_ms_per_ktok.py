"""Device milliseconds of prefill passes (PagedDecoder.forward_chunks) a
thousand prompt tokens, in the traced sub-window."""

from bench import readings


def read(rec):
    return readings.prefill_ms_per_ktok(rec)
