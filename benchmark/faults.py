"""Faults planted under the timed path, to see the comparison that decides
``correct`` fail: the CPU tests plant each in a small run, and
``control.py`` reads a cell's numbers under them on the card, at the
cell's own size, where they set the upper readings of its limits.

Each driver keeps its own faults, ``FAULTS`` in ``drivers/<driver>.py``:
a name to a function that patches the program and returns the function
that takes the fault out again.  ``plant(driver, fault)`` finds them by
the driver's name."""

from __future__ import annotations

import importlib


def patch(obj, name: str, new) -> callable:
    """Set ``obj.name`` to ``new``; returns the function that puts it back."""
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def driver_faults(driver: str) -> dict:
    """The faults of ``drivers/<driver>.py``, by name."""
    return importlib.import_module(f"drivers.{driver}").FAULTS


def plant(driver: str, fault: str) -> callable:
    return driver_faults(driver)[fault]()
