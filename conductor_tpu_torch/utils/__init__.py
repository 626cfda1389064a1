"""Training observability: metric logging, profiling and FLOP counts."""
