"""Frozen copy of the port's scene normalization."""
