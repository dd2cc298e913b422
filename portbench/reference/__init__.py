"""The benchmark's plain reference: SR3 in plain PyTorch, float32, written
apart from the program it judges."""
