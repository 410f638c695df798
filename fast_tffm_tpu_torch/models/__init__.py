"""FM model core."""
