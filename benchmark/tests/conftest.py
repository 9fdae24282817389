"""The benchmark's own tests (not the repository's tier-1 suite):

    python -m pytest benchmark/tests            # on the CPU; card tests skip
    python -m pytest benchmark/tests -m card    # on the card

The harness, its drivers and the plain reference live in benchmark/; the
program is imported from the checkout's root."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m card on the card")
    return torch.device("cuda:0")


class SmallSizes(dict):
    """Each cell's size for a CPU run, ``small/<cell>.json`` (overrides of
    its configuration, traffic and limits, merged as ``run.run_cell``
    merges them), read when a test first asks for the cell.  A cell
    without one fails with the path of the missing file."""

    def __missing__(self, cell: str) -> dict:
        from harness.manifest import load_json

        self[cell] = load_json("small", cell)
        return self[cell]


@pytest.fixture
def small():
    return SmallSizes()
