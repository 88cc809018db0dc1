"""Compute primitives (cost volume, box filter, lattice, dense oracle)."""
