"""Serving engine over the BWAP page pool, and speculative drafting."""
