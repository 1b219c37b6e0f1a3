"""Port counterpart of ``repro.serve``."""
