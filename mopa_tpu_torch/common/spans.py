"""Named spans of the port's host code, the record they keep, and the host
waits on the device counted by the span they fall in.

``with span(name):`` marks a stretch of host code. While a torch profiler
is active the span enters ``torch.profiler.record_function(name)``, so the
trace holds it as a range under that name; ``span(name, trace=False)``
keeps it out of the trace (the sub-stage spans: a profiler range costs
tens of us of host time under the profiler, and the benchmark reads its
stages and idle gaps from the trace). While recording is on, which is
exactly while a torch profiler is active (``torch.autograd.
_profiler_enabled()``) or inside :func:`recording`, each span also appends
one :class:`Span` to the record (:func:`record`): its name, its parent's
id, the step id, its start and end on the profiler's clock, and its thread
(a span's self time is its duration less its children's on its thread).
Off, a span costs one flag check and one call, and allocates nothing.

The record holds one profiler session, or one :func:`recording` block:
the first span recorded under a profiler after a span that was not clears
it, and :func:`recording` clears it on entry. It grows with the session,
a few small tuples a span, as the profiler's own events do.
:meth:`Record.last` keeps a session's last steps.

The clock is ``time.time_ns()``: Unix-epoch nanoseconds, the clock that
kineto stamps the trace's host events and, converted, its device events
with. A span's start is read before its profiler range opens and its end
after the range closes, so the span brackets the range.

Steps: the outermost span of a train step carries its id (``span(
"train/step", step=state.step)``); every span opened until the next such
span carries that id. Where a thread has no span open (autograd's backward
thread), its span's parent is the innermost span open on the thread that
opened the outermost one. At a step's start and end the record keeps a copy
of each counter registered with :func:`counter` (the kernels' launch
counts, ``ops.sparse_conv_cuda.launches``) in a :class:`StepCounts`.

Host waits: while recording, and while an outermost span is open, CUDA's
sync debug mode is set to warn (where CUDA is in use) and its warnings are
taken from Python's warnings machinery on whatever thread raises them, so
each wait of the host on the device that PyTorch flags (``.item()``,
``.cpu()``, a tensor's ``int`` / ``bool`` / ``float``, ``nonzero``, a
boolean-mask index, ``torch.unique``, a blocking device -> host copy, a
stream synchronize) is one :class:`Wait`, counted with the innermost open
span and the port's ``file:line`` that waited. Each wait of the train step
is wrapped in a ``sync/<site>`` span, so the record holds when it started
and ended. The mode and the warnings' filter go back as they were when the
last outermost span closes.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# the text of CUDA's sync debug warning (c10::cuda::warn_or_error_on_sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
_ROOT = str(Path(__file__).resolve().parents[2]) + os.sep
_PACKAGE = _ROOT + "mopa_tpu_torch" + os.sep
_THIS = str(Path(__file__).resolve())


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None      # the enclosing span's id
    step: int | None
    start_ns: int
    end_ns: int
    thread: int


class Wait(NamedTuple):
    span: int | None        # the innermost open span's id
    name: str | None        # and its name
    site: str               # file:line (from the package's root) that waited
    step: int | None


class StepCounts(NamedTuple):
    step: int
    before: dict            # counter name -> copy of its mapping
    after: dict


@dataclass
class Record:
    spans: list = field(default_factory=list)
    waits: list = field(default_factory=list)
    steps: list = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.spans)

    def last(self, n: int) -> "Record":
        """The record of its last ``n`` steps: their counts, and the spans
        and waits of their step ids."""
        steps = self.steps[-n:] if n > 0 else []
        ids = {s.step for s in steps}
        return Record([s for s in self.spans if s.step in ids],
                      [w for w in self.waits if w.step in ids], steps)


class _Recorder:
    """The process's recording state; one instance, :data:`_R`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.record = Record()
        self.explicit = 0       # recording() blocks open
        self.profiled = False   # the last span was recorded for a profiler
        self.next_id = 0
        self.step = None
        self.outer = 0          # threads with a span open
        self.root = None        # open spans of the thread that opened first
        self.counters = {}
        self.saved_mode = None
        self.saved_show = None
        self.filter = None

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.counters.items()}

    # -- host waits ------------------------------------------------------
    def waits_on(self) -> None:
        if torch.cuda.is_initialized():
            self.saved_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.saved_show = warnings.showwarning
        warnings.showwarning = self.show
        warnings.filterwarnings("always", message="(?s).*" + SYNC_WARNING)
        self.filter = warnings.filters[0]

    def waits_off(self) -> None:
        if self.saved_mode is not None:
            torch.cuda.set_sync_debug_mode(self.saved_mode)
            self.saved_mode = None
        if warnings.showwarning == self.show:
            warnings.showwarning = self.saved_show
        try:
            warnings.filters.remove(self.filter)
            warnings._filters_mutated()
        except ValueError:      # the filters were replaced meanwhile
            pass
        self.saved_show = self.filter = None

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        if SYNC_WARNING not in str(message):
            return self.saved_show(message, category, filename, lineno,
                                   file, line)
        st = self.stack() or self.root or []
        top = st[-1] if st else None
        self.record.waits.append(Wait(
            top.id if top else None, top.name if top else None,
            _site(filename, lineno), self.step))


_R = _Recorder()


def _site(filename: str, lineno: int) -> str:
    """The first frame of the port's code (this module aside) up the
    calling stack, as ``mopa_tpu_torch/...py:line``; else the warning's own
    location."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PACKAGE) and name != _THIS:
            return "{}:{}".format(name[len(_ROOT):], f.f_lineno)
        f = f.f_back
    return "{}:{}".format(filename, lineno)


class _Off:
    """The span of a run that is not recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "step", "trace", "id", "parent", "sid", "stack",
                 "range", "start", "before")

    def __init__(self, name: str, step, trace: bool):
        self.name = name
        self.step = step
        self.trace = trace

    def __enter__(self):
        r = _R
        st = self.stack = r.stack()
        with r.lock:
            self.id = r.next_id
            r.next_id += 1
            if not st:
                r.outer += 1
                if r.outer == 1:
                    r.root = st
                    r.waits_on()
            owner = st or r.root
            self.parent = owner[-1].id if owner else None
        if self.step is not None:
            r.step = self.step
            self.before = r.snapshot()
        self.sid = r.step
        st.append(self)
        self.range = record_function(self.name) \
            if self.trace and _profiler_enabled() else None
        self.start = time.time_ns()
        if self.range is not None:
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        r = _R
        st = self.stack
        st.pop()
        r.record.spans.append(Span(self.id, self.name, self.parent, self.sid,
                                   self.start, end, threading.get_ident()))
        if self.step is not None:
            r.record.steps.append(StepCounts(self.step, self.before,
                                             r.snapshot()))
        if not st:
            with r.lock:
                r.outer -= 1
                if r.outer == 0:
                    r.root = None
                    r.waits_off()
        return False


def span(name: str, step: int | None = None, trace: bool = True):
    """A context manager marking ``name`` (module docstring); ``step``
    makes it a step's outermost span, of that id; ``trace=False`` records
    it without a profiler range."""
    r = _R
    if r.explicit:
        return _On(name, step, trace)
    if _profiler_enabled():
        if not r.profiled:      # a new profiler session
            r.profiled = True
            clear()
        return _On(name, step, trace)
    r.profiled = False
    return _OFF


@contextmanager
def recording():
    """Record every span opened inside, with or without a profiler, into
    a cleared record, which it yields."""
    clear()
    with _R.lock:
        _R.explicit += 1
    try:
        yield _R.record
    finally:
        with _R.lock:
            _R.explicit -= 1


def record() -> Record:
    """What recording has kept since the last :func:`clear` (the module
    docstring says when that is)."""
    return _R.record


def clear() -> None:
    _R.record = Record()


def counter(name: str, counts: dict) -> None:
    """Register ``counts`` (a mapping its owner updates in place) to be
    copied into the record at each step's start and end."""
    _R.counters[name] = counts
