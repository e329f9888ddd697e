"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (see each module's note for what it replaces)."""
