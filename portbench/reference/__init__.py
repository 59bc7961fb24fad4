"""The plain reference that decides ``correct``: float64 PyTorch and NumPy,
importing nothing of the port and nothing of JAX."""
