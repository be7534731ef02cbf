"""Plain PyTorch float32 reference of the benchmark's training step; it
imports nothing of the program."""
