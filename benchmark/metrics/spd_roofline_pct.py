"""K4, the blocked Cholesky solve: its share of its roofline in the profiled slice
(harness/roofline.py, rooflines/spd_solve_blocked.py), in %."""

from harness.roofline import share_pct

ROOFLINE = "spd_solve_blocked"


def read(rec):
    return share_pct(rec, ROOFLINE)
