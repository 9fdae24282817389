"""Keyframes the map-maker accepted in the window (integrations whose slot
was free and that made a large point, as the program decides) per 100
frames returned: the number the mapping cell's gate holds."""

COUNTER = "mkfs_accepted"


def read(rec):
    n = rec.counters.get(COUNTER)
    if n is None or rec.unit != "frames" or not rec.units:
        return None
    return 100.0 * n / rec.units
