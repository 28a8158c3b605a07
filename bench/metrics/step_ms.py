"""Host milliseconds an engine step (ServeEngine.step), over the window's
steps."""

from bench import readings


def read(rec):
    return readings.step_ms(rec)
