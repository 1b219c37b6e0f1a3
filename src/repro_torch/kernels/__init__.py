"""Port counterpart of ``repro.kernels``."""
