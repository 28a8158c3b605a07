"""Checkpointing: atomic, hashed, mesh-independent saves."""
