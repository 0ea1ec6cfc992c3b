"""The plain reference of the benchmark: a frozen copy of the port's
modules that the cells drive (`frozen/`), and the lower-precision control
(`control.py`). Imports nothing of the port."""
