"""Input parsing shared by the serving text path."""
