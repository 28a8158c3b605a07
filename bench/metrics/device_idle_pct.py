"""Share of the traced sub-window in which no operation ran on the device, in
%."""

from bench import readings


def read(rec):
    return readings.idle_pct(rec)
