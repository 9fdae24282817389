"""Spans and launch records around calls into the program, installed from
the benchmark's own files by patching the name a caller looks up.

A span synchronises the device at each end, so it times the call's whole
work; it is switched on only outside the profiled slice.  A launch record
only notes a call's shapes (no synchronise), for the roofline counts of
the profiled slice."""

from __future__ import annotations

import importlib
import time
from collections import defaultdict


class Hooks:
    def __init__(self, sync):
        self.sync = sync
        self.spans = defaultdict(list)        # span name -> seconds per call
        self.launches = defaultdict(list)     # kernel -> shape dict per call
        self.spans_on = False
        self.launches_on = False
        self._patched = []

    def _patch(self, module: str, attr: str, make):
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        self._patched.append((mod, attr, orig))

    def span(self, module: str, attr: str, name: str):
        """Time every call of ``module.attr`` under ``name`` while spans are on."""
        def make(orig):
            def timed(*args, **kwargs):
                if not self.spans_on:
                    return orig(*args, **kwargs)
                self.sync()
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                self.sync()
                self.spans[name].append(time.perf_counter() - t0)
                return out
            return timed
        self._patch(module, attr, make)

    def launch(self, module: str, attr: str, kernel: str, shape):
        """Note ``shape(args, kwargs)`` of every call of ``module.attr``
        under ``kernel`` while launch records are on."""
        def make(orig):
            def noted(*args, **kwargs):
                if self.launches_on:
                    self.launches[kernel].append(shape(args, kwargs))
                return orig(*args, **kwargs)
            return noted
        self._patch(module, attr, make)

    def restore(self):
        for mod, attr, orig in reversed(self._patched):
            setattr(mod, attr, orig)
        self._patched.clear()
