"""A frozen copy of the port's plain (whole-tensor PyTorch and NumPy)
modules that the configurations' references run; it imports nothing of the
program, so a later change to the program leaves it as it is."""
