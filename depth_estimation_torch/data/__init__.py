"""Datasets and synthetic fixtures (numpy on the host)."""
