"""The plain reference: float64 PyTorch and NumPy, importing nothing of
the program."""
