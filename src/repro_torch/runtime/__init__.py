"""Runtime loops of the port (serving and training)."""
