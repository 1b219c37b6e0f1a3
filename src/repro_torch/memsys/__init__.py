"""Port counterpart of ``repro.memsys``."""
