"""Calibration I/O (NumPy only)."""
