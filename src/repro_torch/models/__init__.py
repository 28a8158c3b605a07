"""Model configs, dense layers, attention and the causal LM."""
