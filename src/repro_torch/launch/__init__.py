"""Port counterpart of ``repro.launch``."""
