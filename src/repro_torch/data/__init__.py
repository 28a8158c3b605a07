"""Input data (port of ``repro.data``)."""
