"""The benchmark's plain reference (gp.py): plain PyTorch and NumPy,
independent of the program it judges."""
