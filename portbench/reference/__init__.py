"""The plain reference the benchmark holds the port to."""
