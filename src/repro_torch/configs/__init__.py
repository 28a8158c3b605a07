"""Architecture configs (only ``qwen2-0.5b`` is ported so far)."""
