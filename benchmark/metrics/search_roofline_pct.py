"""K2, the fused patch search: its share of its roofline in the profiled slice
(harness/roofline.py, rooflines/search_patches.py), in %."""

from harness.roofline import share_pct

ROOFLINE = "search_patches"


def read(rec):
    return share_pct(rec, ROOFLINE)
