"""Streaming AUC metrics."""
