"""Nothing of JAX, nor the JAX package, may be loaded in the process that
prints the result.  Top-level module names are compared whole: the
port's name, ``mcptam_tpu_torch``, begins with the JAX package's."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mcptam_tpu"})


def forbidden_modules(names=None) -> list:
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
