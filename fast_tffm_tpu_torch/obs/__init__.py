"""Telemetry registry and the HTTP plumbing of the scoring endpoint."""
