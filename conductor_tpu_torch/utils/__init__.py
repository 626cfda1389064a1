"""Training observability: metric logging."""
