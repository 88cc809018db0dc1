"""Task models."""
