"""Batch evaluation over sequences (port of the JAX package's parallel/)."""
