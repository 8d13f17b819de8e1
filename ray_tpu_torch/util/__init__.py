"""Utilities of the port (in-process metric instruments)."""
