"""Port counterpart of ``repro.ft``."""
