"""Plain float32 references that the benchmark holds the program's output
against; they import nothing of the program."""
