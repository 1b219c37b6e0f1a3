"""Port counterpart of ``repro.train`` (the single-device part)."""
