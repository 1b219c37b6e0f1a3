"""Port counterpart of ``repro.optim``."""
