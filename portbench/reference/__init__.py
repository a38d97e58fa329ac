"""The plain reference of the fusion frame (no import of the port)."""
