"""Episode data (numpy)."""
