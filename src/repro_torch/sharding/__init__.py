"""Sharding rules and weighted ZeRO placement (port of ``repro.sharding``)."""
