"""The plain float64 reference of the pull test (NumPy and SciPy only)."""
