"""Input: libsvm parsing, fixed-shape batches and the batch pipeline."""
