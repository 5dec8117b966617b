"""Plain float32 PyTorch of the benchmarked models, with TF32 off; it
imports nothing of the program it judges."""
