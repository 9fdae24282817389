"""Mean ms a call of the map-maker's keyframe integration (the
integrate_mkf_device its tick looks up), from a span with a device
synchronise at each end, over the window before the profiled slice."""

SPAN = ("integrate", "mcptam_tpu_torch.system.mapmaker", "integrate_mkf_device")


def read(rec):
    d = rec.spans.get(SPAN[0])
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
