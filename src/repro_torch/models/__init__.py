"""Port counterpart of ``repro.models``."""
