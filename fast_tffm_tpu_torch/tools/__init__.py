"""On-device probes of the port (the counterparts of the repo's ``tools/``)."""
