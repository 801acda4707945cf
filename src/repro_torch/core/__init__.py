"""Protocol core of the port (``repro.core`` counterpart)."""
