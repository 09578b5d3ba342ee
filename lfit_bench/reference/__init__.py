"""The benchmark's plain float64 reference: a frozen copy of the PyTorch
port's plain paths (no kernel, no routing) that imports nothing of the
port or of the JAX package, and the synthetic light curves it makes."""
