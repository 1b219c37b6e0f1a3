"""Port counterpart of ``repro.checkpoint``."""
