"""A recording stand-in for `dearpygui.dearpygui`, for the tests that hold
the port's `DpgGui` against the JAX package's where dearpygui and a
display are absent.

Every attribute is a function that logs its call: `calls` holds (name,
args, kwargs) with callbacks by name and arrays by shape and dtype, `raw`
the same calls with their arguments as given (so a test can fire a
callback), and `values[tag]` each array passed to `set_value` for that
tag. Each call returns a context manager, so `with dpg.window(...)` works,
and leaving it logs ("end", (name,), {}). A name in @fail raises
RuntimeError when called, as a window that cannot open would.
"""
from __future__ import annotations

import types

import numpy as np


def _plain(v):
    if isinstance(v, np.ndarray):
        return ("array", v.shape, str(v.dtype))
    if callable(v):
        return ("callback", v.__name__)
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


class _Scope:
    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec.calls.append(("end", (self.name,), {}))
        return False


class DpgRecorder(types.ModuleType):
    mvMouseButton_Left = 0
    mvMouseButton_Right = 1

    def __init__(self, fail=()):
        super().__init__("dearpygui.dearpygui")
        self.calls, self.raw, self.values = [], [], {}
        self.fail = set(fail)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            if name in self.fail:
                raise RuntimeError(f"dearpygui stand-in: {name} failed")
            self.calls.append((name, _plain(args),
                               {k: _plain(v) for k, v in kwargs.items()}))
            self.raw.append((name, args, kwargs))
            if name == "set_value" and isinstance(args[1], np.ndarray):
                self.values.setdefault(args[0], []).append(args[1].copy())
            return _Scope(self, name)

        return call


def as_package(rec):
    """{module name: module} to put in `sys.modules` so that `import
    dearpygui.dearpygui as dpg` gives @rec."""
    parent = types.ModuleType("dearpygui")
    parent.dearpygui = rec
    return {"dearpygui": parent, "dearpygui.dearpygui": rec}
