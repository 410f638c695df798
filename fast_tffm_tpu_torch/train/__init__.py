"""Checkpoint I/O (training itself is a later slice of the port)."""
