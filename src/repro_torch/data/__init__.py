"""Port counterpart of ``repro.data``."""
