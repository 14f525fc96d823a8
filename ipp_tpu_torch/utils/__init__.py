"""Host utilities of the port (device and precision policy)."""
