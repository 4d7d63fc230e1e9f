"""Runtime loops of the port (serving)."""
