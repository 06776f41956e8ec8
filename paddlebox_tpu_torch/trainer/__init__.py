"""Training loop driver."""
