"""Spans and counters of the port, on one clock with the device.

``span(name, id=None, device=True, **attrs)`` marks one layer of the
program (an export request, a batch's generator, a critic iteration),
never a single kernel.  Tracing is on exactly while a ``torch.profiler``
session records (``torch.autograd.profiler._is_profiler_enabled``); off,
``span`` tests that flag and returns a shared null context.  On, a span
records its name, its parent, its root's id (``id`` of the outermost
span: the request's seed, the step number), its attributes and its host
start and end, and enters ``torch.profiler.record_function`` (so a trace
with CPU activity shows the span, and its device extent as a
``gpu_user_annotation``; a root with an id as ``"<name> <id>"``).  Where
CUDA is initialised it also records a timing event on the current stream
at entry and at exit, unless ``device=False``: a span that leads a
profiled stretch with host work (the export's request and build) keeps
host times only, so that the stretch's first CUDA call stays the
program's own.  It makes no synchronisation and issues no device
operation.

``count(name, n)`` adds to ``counters``, the one registry of the port's
counters (the kernels' launches and weight packings: ``k1.fwd_launches``,
``k1.packs``, ...).  Counting is always on; ``reset()`` clears it.

A session is one profiler session: it starts at the first span after the
profiler turns on and ends at ``last_session()`` or at the first span
after it turns off.  ``last_session()`` returns its ``Session``: the spans,
the counters' change from the session's first span to the end of its last
root span, and each span's device start and end.

The clock is the host's ``CLOCK_REALTIME`` in nanoseconds (``time.time_ns``),
the clock of ``torch.profiler``'s Chrome trace: a trace's ``ts`` is
``(t - baseTimeNanoseconds) / 1000``.  Device times come to it when the
session ends, once the device has run the session's work: one anchor
event is recorded and its host time read when the host first sees it
complete; an event's device time is the anchor's less
``elapsed_time(event, anchor)``.  A span's device extent runs from the
stream reaching its entry to the stream reaching its exit, idle included.
Without CUDA the host is the device: a span's device extent is its host
extent.  Where the device was idle is the trace's to say
(``portbench/trace.py``); laid over the spans' host times, it names the
layer the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch
from torch.autograd import profiler as _profiler

SPAN_CAP = 200_000        # spans a session records; later ones are counted

counters: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()
_local = threading.local()
_open = None              # the session being recorded
_last = None              # the last session ended


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    counters[name] += n


def reset() -> None:
    """Set every counter to zero."""
    counters.clear()


@dataclasses.dataclass
class Span:
    """One recorded span.  Times are ``time.time_ns`` nanoseconds; the
    device's are None until the session ends (and where a span was still
    open then, its end)."""
    name: str
    index: int                       # in ``Session.spans``
    parent: int | None               # its index, None for a root
    root: int                        # the root's index
    id: object                       # the root's id
    depth: int                       # 0 for a root
    attrs: dict
    host_start: int = 0
    host_end: int | None = None
    device_start: int | None = None
    device_end: int | None = None

    @property
    def device_ns(self) -> int | None:
        """The span's device extent."""
        if self.device_start is None or self.device_end is None:
            return None
        return self.device_end - self.device_start


@dataclasses.dataclass
class Session:
    """What one profiler session recorded."""
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    dropped: int = 0                 # spans past ``SPAN_CAP``

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def device_s(self, *names: str) -> float | None:
        """The summed device extents of the spans named, in seconds (None
        where none is recorded or one lacks its device times)."""
        ext = [s.device_ns for s in self.spans if s.name in names]
        if not ext or None in ext:
            return None
        return sum(ext) * 1e-9


class _Recording:
    """The session being recorded, with its events still on the device."""

    def __init__(self):
        self.session = Session()
        self.start_counts = dict(counters)
        self.end_counts = self.start_counts
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.events = []             # [(span, entry event, exit event)]
                                     # of the spans with device times

    def end(self) -> Session:
        s = self.session
        s.counters = {k: v - self.start_counts.get(k, 0)
                      for k, v in self.end_counts.items()
                      if v != self.start_counts.get(k, 0)}
        if not self.cuda:
            for sp, _, _ in self.events:
                sp.device_start, sp.device_end = sp.host_start, sp.host_end
        elif self.events:
            _device_times(self.events)
        return s


def _device_times(events) -> None:
    """Each span's device start and end on the host clock."""
    torch.cuda.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    while not anchor.query():
        pass
    at = time.time_ns()
    for sp, a, b in events:
        sp.device_start = at - int(a.elapsed_time(anchor) * 1e6)
        if sp.host_end is not None:
            sp.device_end = at - int(b.elapsed_time(anchor) * 1e6)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Live:
    """A span while tracing is on."""
    __slots__ = ("name", "id", "device", "attrs", "rec", "span", "rf",
                 "exit_event")

    def __init__(self, name, id, device, attrs):
        self.name, self.id, self.device, self.attrs = name, id, device, attrs

    def __enter__(self):
        global _open
        if _open is None:
            _open = _Recording()
        rec = self.rec = _open
        st = _stack()
        parent = st[-1].span if st and st[-1].rec is rec else None
        label = self.name
        if parent is None and self.id is not None:
            label = f"{self.name} {self.id}"
        self.rf = torch.profiler.record_function(label)
        self.rf.__enter__()
        s = rec.session
        self.span = self.exit_event = None
        if len(s.spans) >= SPAN_CAP:
            s.dropped += 1
            return self
        index = len(s.spans)
        sp = self.span = Span(
            name=self.name, index=index, attrs=self.attrs,
            parent=None if parent is None else parent.index,
            root=index if parent is None else parent.root,
            id=self.id if parent is None else parent.id,
            depth=0 if parent is None else parent.depth + 1)
        s.spans.append(sp)
        st.append(self)
        if self.device and not rec.cuda:
            rec.events.append((sp, None, None))
        elif self.device:
            entry, self.exit_event = (torch.cuda.Event(enable_timing=True)
                                      for _ in range(2))
            rec.events.append((sp, entry, self.exit_event))
            entry.record()
        sp.host_start = time.time_ns()
        return self

    def __exit__(self, *exc):
        sp = self.span
        if sp is not None:
            if self.exit_event is not None:
                self.exit_event.record()
            sp.host_end = time.time_ns()
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            if sp.parent is None:
                self.rec.end_counts = dict(counters)
        self.rf.__exit__(*exc)
        return False


def span(name: str, id=None, device: bool = True, **attrs):
    """A span of the program named ``name`` (``id``: the root's id, read
    only on a root; ``device=False``: host times only).  A null context
    unless a profiler records."""
    if not _profiler._is_profiler_enabled:
        if _open is not None:
            _end_open()
        return _NULL
    return _Live(name, id, device, attrs)


def _end_open() -> None:
    global _open, _last
    rec, _open = _open, None
    _last = rec.end()


def last_session() -> Session:
    """The last profiler session's record (ending the one being recorded);
    an empty ``Session`` where none was."""
    if _open is not None:
        _end_open()
    return _last if _last is not None else Session()
