"""Frozen copy of the port's Neural Object Field: field, render, losses,
the Adam step and the runner."""
