"""Plain references of the benchmark's configurations: PyTorch and NumPy
only, importing nothing of the program under test."""
