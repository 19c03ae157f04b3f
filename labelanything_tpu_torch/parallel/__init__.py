"""Training and evaluation steps."""
