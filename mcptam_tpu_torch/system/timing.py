"""The port's tracer, and its timing records in the reference's message
taxonomy (port of mcptam_tpu/system/timing.py; msg/TrackerTiming.msg,
msg/MapMakerTiming.msg).

Spans.  ``with span(name, id):`` around a stage of the program records the
stage's name, the span open around it in the same thread (its parent), a
request id (the frame id on the frame path, the host-side step index on the
LM path; a span given none takes its parent's), its start and end on the
clock of torch.profiler's kineto events (unix-epoch ns, ``time.time_ns``),
and the host synchronisations made inside it.  A span times the host: what
it encloses is the enqueue of its device work, unless the synchronous mode
is on.  Records go into a ring of ``CAPACITY``; the records it pushes out
are counted (``report()["dropped"]``).

On and off.  The tracer records while a torch.profiler session records in
this thread, or while ``enable(True)`` holds.  Off, ``span`` costs one
flag check and returns a shared no-op.  Spans emit no profiler event, so a
profiled trace holds the same device operations with the tracer on.

Host synchronisations.  While the tracer is on and CUDA is initialised,
the outermost span of a thread switches CUDA's sync debug mode to "warn"
and takes in its warnings (it prints none): every wait the mode reports
counts one on the innermost open span, the enclosing spans included, and
one at its source line (``sync_sites``).  On an H100 under PyTorch 2.11
the mode reports blocking copies either way (``.item()``, ``.cpu()``,
``int()``/``bool()`` of a device tensor, ``torch.tensor(..., device=)``,
indexing by a 0-d device tensor), ``nonzero`` and mask indexing, library
error checks (``torch.linalg.pinv`` two, ``torch.linalg.solve`` one) and
``Stream.synchronize``; it misses ``Event.synchronize``, which the program
makes through ``wait`` here, which counts itself.

``enable(True, sync=True)`` ends every span (and starts every outermost
one) with a device synchronise, so that each span holds its own device
work: ``System.profile_frame``'s mode.  ``attribute_idle(prof)`` joins a
finished profiler's device operations to the spans open when each was
launched.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import threading
import time
import warnings
from collections import Counter, deque
from typing import NamedTuple

import torch

CAPACITY = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class TrackerTiming:
    """Host seconds of a frame's stages, from its spans (``frame_timings``);
    zero while the tracer is off.  kf_downsample the front-end
    (``frontend.features``), sbi .. pose the tracker's stages of the same
    names, depth its finalize step, add the frame's tail (point statistics,
    the add heuristic, the scalar pack); total their sum."""
    kf_downsample: float = 0.0
    kf_feature: float = 0.0
    sbi: float = 0.0
    motion: float = 0.0
    pvs: float = 0.0
    coarse: float = 0.0
    fine: float = 0.0
    pose: float = 0.0
    depth: float = 0.0
    add: float = 0.0
    total: float = 0.0
    map_num_points: int = 0
    map_num_mkfs: int = 0


@dataclasses.dataclass
class MapMakerTiming:
    """One map-maker action (src/MapMaker.cc:197-265): host seconds it took
    and, for a finished BA, its accepted and total LM iterations."""
    elapsed: float = 0.0
    accepted_iterations: int = 0
    total_iterations: int = 0
    kind: str = "none"  # "local" | "global" | "creation" | "creation-rejected"
    map_num_points: int = 0
    map_num_mkfs: int = 0


class Span(NamedTuple):
    """One closed span."""
    name: str
    id: object
    seq: int          # order of opening
    parent: int       # seq of the enclosing span of its thread, -1 at the top
    start_ns: int     # unix-epoch ns, the clock of the profiler's kineto events
    end_ns: int
    self_ns: int      # duration less what its child spans cover
    syncs: int        # host synchronisations inside it, its children's included


class _Local(threading.local):
    def __init__(self):
        self.stack = []     # open spans, innermost last


_local = _Local()
_lock = threading.Lock()
_records = deque(maxlen=CAPACITY)
_appended = 0               # records ever appended
_cleared_at = 0             # _appended at the last clear()
_seq = 0
_sites = Counter()          # "file:line" -> synchronisations counted there
_on = False
_sync = False
_profiling = torch._C._autograd._profiler_enabled
_debug_users = 0            # outermost spans open with the debug mode on
_debug_saved = None


def enable(on: bool = True, sync: bool = False) -> tuple:
    """Switch the tracer on (or off) whatever the profiler does; ``sync``
    puts it in the synchronous mode.  Returns the previous (on, sync), for
    ``enable(*prev)``."""
    global _on, _sync
    prev = (_on, _sync)
    _on, _sync = bool(on), bool(on) and bool(sync)
    return prev


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, kind: str):
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "id", "seq", "parent", "start", "child_ns", "syncs", "debug")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def tag(self, kind: str):
        """Name the span ``<name>:<kind>``, for a kind known only inside it."""
        self.name = f"{self.name.split(':', 1)[0]}:{kind}"

    def __enter__(self):
        global _seq
        st = _local.stack
        if st:
            top = st[-1]
            self.parent = top.seq
            if self.id is None:
                self.id = top.id
            self.debug = False
        else:
            self.parent = -1
            self.debug = _debug_enter()
            if _sync:
                _device_sync()
        with _lock:
            self.seq = _seq
            _seq += 1
        self.child_ns = self.syncs = 0
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if _sync:
            _device_sync()
        end = time.time_ns()
        st = _local.stack
        st.pop()
        dur = end - self.start
        if st:
            st[-1].child_ns += dur
            st[-1].syncs += self.syncs
        _append(Span(self.name, self.id, self.seq, self.parent, self.start, end,
                     dur - self.child_ns, self.syncs))
        if self.debug:
            _debug_exit()
        return False


def span(name: str, id=None):
    """A context manager recording ``name`` while the tracer is on."""
    if not (_on or _profiling()):
        return _NOOP
    return _Span(name, id)


def _append(rec: Span):
    global _appended
    with _lock:
        _records.append(rec)
        _appended += 1


def count_sync(n: int = 1, site: str = None):
    """Count ``n`` host synchronisations on this thread's innermost open
    span, at ``site`` ("file:line", by default the caller's)."""
    st = _local.stack
    if st:
        st[-1].syncs += n
        if site is None:
            f = sys._getframe(1)
            site = f"{f.f_code.co_filename}:{f.f_lineno}"
        _sites[site] += n


def wait(event):
    """Block the host on ``event`` (a torch.cuda.Event; None on the CPU,
    which does nothing) and count the wait, which the debug mode misses."""
    if event is None:
        return
    event.synchronize()
    f = sys._getframe(1)
    count_sync(site=f"{f.f_code.co_filename}:{f.f_lineno}")


def _device_sync():
    """The synchronous mode's own synchronise (the debug mode does not
    report ``torch.cuda.synchronize``, so it is not counted)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(SYNC_WARNING):
        count_sync(site=f"{filename}:{lineno}")
        return
    _debug_saved[1](message, category, filename, lineno, file, line)


def _debug_enter() -> bool:
    """Turn CUDA's sync debug mode to "warn" and take in its warnings,
    for the first outermost span open in the process."""
    global _debug_users, _debug_saved
    if not torch.cuda.is_initialized():
        return False
    with _lock:
        _debug_users += 1
        if _debug_users == 1:
            cm = warnings.catch_warnings()
            cm.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            _debug_saved = (cm, warnings.showwarning, torch.cuda.get_sync_debug_mode())
            warnings.showwarning = _on_warning
            torch.cuda.set_sync_debug_mode("warn")
    return True


def _debug_exit():
    global _debug_users, _debug_saved
    with _lock:
        _debug_users -= 1
        if _debug_users == 0:
            cm, _, mode = _debug_saved
            torch.cuda.set_sync_debug_mode(mode)
            cm.__exit__(None, None, None)
            _debug_saved = None


def mark() -> int:
    """A position in the record stream, for ``since``."""
    return _appended


def since(position: int) -> list:
    """The records closed after ``mark()`` returned ``position``, those
    still in the ring, oldest first."""
    with _lock:
        n = min(_appended - position, len(_records))
        return [_records[i] for i in range(len(_records) - n, len(_records))] if n > 0 else []


def records() -> list:
    """Every record in the ring, in the order they closed."""
    with _lock:
        return list(_records)


def clear():
    """Empty the ring, its count of drops and the synchronisation sites."""
    global _cleared_at
    with _lock:
        _records.clear()
        _cleared_at = _appended
        _sites.clear()


def sync_sites() -> dict:
    """{"file:line": host synchronisations counted there inside a span}."""
    with _lock:
        return dict(_sites)


def report() -> dict:
    """{"spans": {name: {"count", "total_ms", "self_ms", "syncs"}},
    "dropped": records pushed out of the ring since the last clear()}."""
    out = {}
    for r in records():
        d = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0, "syncs": 0})
        d["count"] += 1
        d["total_ms"] += (r.end_ns - r.start_ns) * 1e-6
        d["self_ms"] += r.self_ns * 1e-6
        d["syncs"] += r.syncs
    with _lock:
        dropped = _appended - _cleared_at - len(_records)
    return {"spans": out, "dropped": dropped}


# the frame path's spans -> TrackerTiming's fields
TRACKER_FIELDS = {
    "frontend.features": "kf_downsample", "tracker.sbi": "sbi", "tracker.motion": "motion",
    "tracker.pvs": "pvs", "tracker.coarse": "coarse", "tracker.fine": "fine",
    "tracker.pose": "pose", "tracker.finalize": "depth", "system.frame_tail": "add",
}
_TIMED = [f.name for f in dataclasses.fields(TrackerTiming)
          if f.name not in ("total", "map_num_points", "map_num_mkfs")]


def frame_timings(recs) -> dict:
    """{frame id: TrackerTiming} of the frames whose spans are in ``recs``."""
    out = {}
    for r in recs:
        f = TRACKER_FIELDS.get(r.name)
        if f is None or r.id is None:
            continue
        t = out.setdefault(r.id, TrackerTiming())
        setattr(t, f, getattr(t, f) + (r.end_ns - r.start_ns) * 1e-9)
    for t in out.values():
        t.total = sum(getattr(t, f) for f in _TIMED)
    return out


def _is_launch(ev) -> bool:
    """A runtime call that puts work on the device (kernel launch, copy,
    set), as the profiler records it on the host."""
    n = ev.name()
    return n.startswith(("cuda", "cu")) and ("Launch" in n or "Memcpy" in n or "Memset" in n)


def attribute_idle(prof, recs=None) -> dict:
    """Join a finished torch.profiler session's device operations to the
    spans (``recs``, every record by default): each operation goes to the
    innermost span open on the host when its launch (the runtime call the
    profiler links to it by correlation id) was made, and each idle gap of
    the device to the span that launched the operation ending it.  Returns
    {span name: {"ops", "device_s", "idle_s"}}, operations launched outside
    every span under "(no span)".  Spans of several threads that overlap
    in time are taken as nested."""
    recs = records() if recs is None else list(recs)
    launch_ns, ops = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA":
            ops.append((ev.start_ns(), ev.duration_ns(), ev.correlation_id()))
        elif _is_launch(ev):
            launch_ns[ev.correlation_id()] = ev.start_ns()
    # the timeline cut where a span starts or ends; each piece to the
    # innermost span open over it (the latest start)
    edges = sorted([(r.end_ns, 0, i) for i, r in enumerate(recs)]
                   + [(r.start_ns, 1, i) for i, r in enumerate(recs)])
    cuts, owner, live = [], [], set()
    for t, starts, i in edges:
        (live.add if starts else live.discard)(i)
        if cuts and cuts[-1] == t:
            cuts.pop()
            owner.pop()
        cuts.append(t)
        owner.append(recs[max(live, key=lambda j: recs[j].start_ns)].name if live else None)

    def at(t):
        i = bisect.bisect_right(cuts, t) - 1
        return (owner[i] if i >= 0 else None) or "(no span)"

    out = {}
    busy_end = None
    for s, d, corr in sorted(ops):
        t = launch_ns.get(corr)
        name = at(t) if t is not None else "(no span)"
        row = out.setdefault(name, {"ops": 0, "device_s": 0.0, "idle_s": 0.0})
        row["ops"] += 1
        row["device_s"] += d * 1e-9
        if busy_end is not None and s > busy_end:
            row["idle_s"] += (s - busy_end) * 1e-9
        busy_end = s + d if busy_end is None else max(busy_end, s + d)
    return out
