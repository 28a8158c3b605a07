"""Device milliseconds a decode pass (ServeEngine._decode_launch:
PagedDecoder.decode_step and its argmax), in the traced sub-window."""

from bench import readings


def read(rec):
    return readings.phase_ms(rec, "decode")
