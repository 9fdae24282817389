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


# small sizes a CPU run can hold: 2 cameras at 240x320, a 12-corner-a-level
# map, a 16-pose loop in batches of 4; BA over 8 poses
SMALL = {
    "rig4_vga_m16.track": {
        "config": {"rig": {"n_cams": 2, "height": 240, "width": 320},
                   "capacity": {"max_points": 1024, "max_mkfs": 8, "max_meas": 4096}},
        "traffic": {"map": {"n_per_level": 12}, "trajectory": {"n_poses": 16}, "batch": 4,
                    "pipeline_depth": 8, "warmup_batches": 2, "profile_batches": 1,
                    "judge": {"batches": 1}, "gates": {"min_mean_found": 10}},
    },
    "rig4_vga_m48.ba": {
        "traffic": {"problem": {"n_poses": 8, "n_points": 512, "sparse_k": 4096},
                    "n_problems": 2, "judge": {"problems": 1}},
    },
}


@pytest.fixture
def small():
    return SMALL
