"""Dataset metadata of the port (numpy-free, torch-free)."""
