"""Tasks of the port (inference half; training comes with its own slice)."""
