"""The (data, model) rank mesh and its collectives."""
