"""Data utilities of the port: contrastive pair sampling (`pairs`)."""
