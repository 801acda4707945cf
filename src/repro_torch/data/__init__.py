"""Data generators of the port (``repro.data`` counterpart)."""
