"""The program's own trace for the manifest's assembly test.

``tests/test_bench_manifest.py`` assembles every cell's metrics from a
fixed Record (``recorded``) that predates the program's spans: the readers
of ``harness/program_spans.py`` read what the program's tracer
(``mcptam_tpu_torch/system/timing.py``) recorded over the profiled slice,
which no Record holds.  Around each of that file's tests the tracer holds
such a trace: every span those readers name, a counted wait inside each
step span."""

import pytest

SPANS = {
    "system.batch_step": ("frontend.features", "tracker.track_frame", "tracker.sbi",
                          "tracker.pvs", "tracker.coarse", "tracker.fine", "tracker.pose",
                          "tracker.finalize", "system.drain_wait"),
    "ba.lm_step": ("ba.robust", "ba.schur", "ba.resid_jac", "ba.solve", "ba.trial",
                   "ba.update"),
}


@pytest.fixture(autouse=True)
def program_trace(request):
    if request.module.__name__.rsplit(".", 1)[-1] != "test_bench_manifest":
        yield
        return
    from mcptam_tpu_torch.system import timing

    prev = timing.enable(True)
    timing.clear()
    for step, names in SPANS.items():
        with timing.span(step, 0):
            timing.count_sync()
            for name in names:
                with timing.span(name):
                    pass
    timing.enable(*prev)
    yield
    timing.clear()
