"""CLIs of the port."""
