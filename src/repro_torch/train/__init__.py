"""Training (port of ``repro.train``): the optimizer, the train and eval
steps, the crash-safe trainer and the compressed gradient all-reduce."""
