"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the plain reference loads nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness.guard import forbidden_modules
from harness.manifest import load_json, load_manifest

BENCH = Path(__file__).resolve().parent.parent
# what the plain reference may import: the standard library's modules it
# uses, torch, numpy, and itself
ALLOWED = {"plainref", "torch", "numpy", "__future__", "dataclasses", "functools", "math",
           "typing", "os", "importlib"}


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["mcptam_tpu_torch", "mcptam_tpu_torch.ba", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "mcptam_tpu", "mcptam_tpu.ops", "flax",
                              "jaxlib"]) == ["flax", "jax.numpy", "jaxlib", "mcptam_tpu",
                                             "mcptam_tpu.ops"]


def _modules_after(code: str) -> set:
    """Top-level names in sys.modules after running ``code`` in a fresh
    interpreter whose path holds the benchmark and the checkout."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(out.stdout.split())


def _plainref_modules() -> list:
    return sorted("plainref." + ".".join(p.relative_to(BENCH / "plainref").with_suffix("").parts)
                  for p in (BENCH / "plainref").rglob("*.py") if p.name != "__init__.py")


def test_the_reference_imports_nothing_of_the_program():
    mods = _plainref_modules()
    names = _modules_after("\n".join(f"import {m}" for m in mods))
    assert "plainref" in names
    assert not names & {"mcptam_tpu_torch", "mcptam_tpu", "jax", "jaxlib", "flax"}
    for p in (BENCH / "plainref").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert all(m.split(".")[0] in ALLOWED for m in mods), (p, mods)


@pytest.mark.parametrize("driver", sorted({load_json("traffic", w["traffic"])["driver"]
                                            for w in load_manifest()["workloads"]}))
def test_a_run_loads_no_jax(driver):
    """The harness, a driver, its metrics and the program's modules the
    driver reaches, as a run imports them."""
    code = ("import run, smoke, control\n"
            f"import drivers.{driver} as d\n"
            "from harness import manifest as mf\n"
            "M = mf.load_manifest()\n"
            "for r in mf.ROLES:\n"
            "    for m in M[r]:\n"
            "        if r == 'per_layer': mf.load_module('metrics', m['name'])\n"
            "import mcptam_tpu_torch.system.system, mcptam_tpu_torch.ba.bundle\n"
            "import mcptam_tpu_torch.io.synthetic, mcptam_tpu_torch.csrc._build\n"
            "import plainref.tracker.tracker, plainref.ba.bundle, plainref.ba.problems\n"
            "import plainref.io.synthetic, plainref.map.keyframe\n")
    names = _modules_after(code)
    assert "mcptam_tpu_torch" in names and "plainref" in names
    assert not names & {"jax", "jaxlib", "flax", "mcptam_tpu"}


def test_the_harness_reads_no_file_of_the_old_benchmark():
    for p in BENCH.rglob("*.py"):
        if {"tests", "plainref"} & set(p.relative_to(BENCH).parts):
            continue
        text = p.read_text()
        for old in ("bench.py", "BENCH_r0", "BASELINE.json", "scripts/", "chip_smoke"):
            assert old not in text, (p, old)
