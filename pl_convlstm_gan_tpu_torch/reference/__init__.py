"""Plain float32 PyTorch references of the port's models, written from their
published descriptions; they import nothing of the port's models, ops or
kernels, and the tests hold the port to them."""
