"""p95 over requests due in the window of the time from due to the step that
ran their first prefill chunk."""

from bench import readings


def read(rec):
    return readings.queue_wait_ms(rec, 95)
