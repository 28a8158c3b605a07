"""Seconds from the process's start to the window's: weights, engine,
warm-up, pre-roll."""


def read(rec):
    return rec["setup_s"]
