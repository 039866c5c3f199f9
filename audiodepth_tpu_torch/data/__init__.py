"""Data-side ops of the port (the audio front end)."""
