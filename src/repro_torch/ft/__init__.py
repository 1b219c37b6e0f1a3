"""Port counterpart of ``repro.ft`` (the single-device part)."""
