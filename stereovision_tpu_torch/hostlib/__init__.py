"""Native host helpers (ctypes)."""
