"""Online scoring: fixed-shape scorer, request batcher, HTTP endpoint."""
