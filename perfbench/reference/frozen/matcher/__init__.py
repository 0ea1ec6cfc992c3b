"""Frozen copy of the port's ORB matcher."""
