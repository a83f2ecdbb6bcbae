"""Plain PyTorch references of the benchmark's models: float32 with TF32 off, importing nothing of the program."""
