"""Port counterpart of ``repro.core``."""
