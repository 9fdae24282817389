"""The map-maker's window gather (K2's plain gather, csrc/gather.cu) as a
share of its roofline over the profiled slice."""

from harness.roofline import share_pct

ROOFLINE = "gather_windows"


def read(rec):
    return share_pct(rec, ROOFLINE)
