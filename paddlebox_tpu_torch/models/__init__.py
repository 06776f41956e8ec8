"""Dense models as torch modules."""
