"""Training: losses, optimizer, metrics and substitution."""
