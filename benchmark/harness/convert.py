"""Hand the same inputs to both sides, and the program's state to the
reference: a dataclass tree of one package is rebuilt as the class of the
same module path and name in the other, field by field over the target
class's fields, every tensor cloned (so neither side sees the other's
later in-place updates)."""

from __future__ import annotations

import dataclasses
import importlib

import torch

PROGRAM, REFERENCE = "mcptam_tpu_torch", "plainref"


def clone_tree(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: clone_tree(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(clone_tree(v) for v in obj)
    return obj


def to_host(obj):
    """A copy of a dataclass tree of tensors on the host."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return obj.to("cpu", copy=True)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def tree_gaps(got, ref, path: str = "") -> dict:
    """{field path: gap} over two dataclass trees of the same shape: for a
    float tensor its largest element gap over the reference's largest
    element, for any other field the count of elements that differ."""
    if dataclasses.is_dataclass(ref):
        out = {}
        for f in dataclasses.fields(ref):
            out.update(tree_gaps(getattr(got, f.name), getattr(ref, f.name),
                                 f"{path}.{f.name}" if path else f.name))
        return out
    if isinstance(ref, torch.Tensor):
        a, b = got.cpu(), ref.cpu()
        if a.shape != b.shape:
            return {path: float("inf")}
        if b.is_floating_point():
            d = (a.double() - b.double()).abs()
            return {path: float(d.max()) / max(float(b.abs().max()), 1e-30) if d.numel() else 0.0}
        return {path: int((a != b).sum())}
    if isinstance(ref, (tuple, list)):
        out = {}
        for i, (g, r) in enumerate(zip(got, ref)):
            out.update(tree_gaps(g, r, f"{path}[{i}]"))
        return out
    return {path: int(got != ref)}


def _convert(obj, src: str, dst: str):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if mod.startswith(dst + "."):
            return clone_tree(obj)
        if not mod.startswith(src + "."):
            raise TypeError(f"{type(obj).__name__} is not a class of {src}")
        cls = getattr(importlib.import_module(dst + mod[len(src):]), type(obj).__name__)
        return cls(**{f.name: _convert(getattr(obj, f.name), src, dst)
                      for f in dataclasses.fields(cls) if f.init})
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_convert(v, src, dst) for v in obj)
    return obj


def to_reference(obj):
    """A program object as the reference's class of the same name."""
    return _convert(obj, PROGRAM, REFERENCE)


def to_program(obj):
    """A reference object (an input the benchmark made) as the program's class."""
    return _convert(obj, REFERENCE, PROGRAM)
