"""LAM model modules (PyTorch)."""
