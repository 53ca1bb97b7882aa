"""Deterministic synthetic image corpora."""
