"""Metrics (the training loop is not ported yet)."""
