"""Roofline terms and the dispatch-level counter of the dry-run."""
