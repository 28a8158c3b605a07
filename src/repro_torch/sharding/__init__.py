"""Sharding rules (the KV pool's layout spec so far)."""
