"""The program's own trace for the manifest's assembly test.

``tests/test_bench_manifest.py`` assembles every cell's metrics from a
fixed Record (``recorded``): the readers that read what the program's
tracer (``mcptam_tpu_torch/system/timing.py``) recorded over the profiled
slice find no such record in it.  Each of them declares what it reads,
``PROGRAM_SPANS``: a step span, then the spans it encloses.  Around each
of that file's tests the tracer holds a trace built from those
declarations over the manifest's per-layer metrics: every step span once,
a counted wait inside it, and every span declared under it."""

import pytest


def declared_spans() -> dict:
    """{step span: [the spans declared under it]} over the manifest's
    per-layer metrics."""
    from harness import manifest as mf

    out = {}
    for m in mf.load_manifest()["per_layer"]:
        decl = getattr(mf.load_module("metrics", m["name"]), "PROGRAM_SPANS", None)
        if decl:
            names = out.setdefault(decl[0], [])
            names += [n for n in decl[1:] if n not in names]
    return out


@pytest.fixture(autouse=True)
def program_trace(request):
    if request.module.__name__.rsplit(".", 1)[-1] != "test_bench_manifest":
        yield
        return
    from mcptam_tpu_torch.system import timing

    prev = timing.enable(True)
    timing.clear()
    for step, names in declared_spans().items():
        with timing.span(step, 0):
            timing.count_sync()
            for name in names:
                with timing.span(name):
                    pass
    timing.enable(*prev)
    yield
    timing.clear()
