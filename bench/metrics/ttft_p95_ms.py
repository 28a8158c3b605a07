"""p95 over every request due in the window of the time from its due time to
the return of the step that gave its first token; one with none by the end
of the run counts to the end."""

from bench import readings


def read(rec):
    return readings.ttft_ms(rec, 95)
