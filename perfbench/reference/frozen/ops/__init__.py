"""Frozen copy of the port's device ops; the hash-grid backward is the
plain `index_add_` (`scatter.py`)."""
