"""The port's recorder of spans and counters, kept per request.

A request is one proof: the load of its bundle, the claim, the trace build,
the prove and the serialization.  Its id rides on the objects (the loaded
public input, the claim, the trace, the proof), never in a process-wide
"current request": a span opened with `request=` starts a tree of that
request, and a span opened without one joins the innermost span open in
the same context (a contextvars.ContextVar: two proofs in flight on two
threads stay apart).  A span with no request to join is not recorded.

    span(name, request=None, **attrs)   a context manager: name, start and
                                        end (time.perf_counter_ns, the clock
                                        of the benchmark's window), parent,
                                        request, attrs, and its counts
    count(name, n)                      adds n to the innermost open span
    Sections()                          consecutive spans under the open one
    to_device(x, device, name)          h2d.<name>, counting h2d_bytes
    to_host(t, name)                    d2h.<name>, counting d2h_bytes
    requests(), get(rid)                the recorded requests, oldest first;
                                        one of them by id

Spans go at batch and layer boundaries, never inside a loop over rows,
instances or queries, and add no device synchronize.  With no profiler
active a span costs two clock reads, a context-variable set and reset and
an append; while a torch.profiler is active each span also enters
torch.profiler.record_function(name), so that a profiler trace shows the
program's spans on the clock of its kernels and copies.

Tally is a process-wide Counter (the kernel launches, the Pedersen hashes
by route) whose every increment is also charged, as `<prefix>.<key>`, to
the innermost open span.  The store keeps the last MAX_REQUESTS requests.
"""

import collections
import contextvars
import itertools
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

MAX_REQUESTS = 256

_OPEN = contextvars.ContextVar("sandstorm_tpu_torch_open_span", default=None)
_STORE = collections.OrderedDict()
_LOCK = threading.Lock()
_IDS = itertools.count(1)


def _first_range():
    """record_function's first call in a process takes about 1.5 ms (the
    first dispatch of its op): taken here, while no profiler records it, it
    falls in no profiled span."""
    if not _autograd_profiler._is_profiler_enabled:
        with record_function("sandstorm_tpu_torch.telemetry"):
            pass


_first_range()


class Request:
    """The spans of one proof, in the order they were opened."""

    __slots__ = ("id", "spans")

    def __init__(self, rid: int):
        self.id = rid
        self.spans = []

    def find(self, name: str):
        """The spans called `name`; a name ending in ".*" matches every span
        whose name starts with what comes before the "*"."""
        if name.endswith(".*"):
            return [s for s in self.spans if s.name.startswith(name[:-1])]
        return [s for s in self.spans if s.name == name]

    def seconds(self, *names) -> float:
        """Summed seconds of the spans `names` match (see find)."""
        return sum(s.seconds for name in names for s in self.find(name))

    def counts(self) -> collections.Counter:
        """Every span's counts added up."""
        total = collections.Counter()
        for s in self.spans:
            if s.counts:
                total.update(s.counts)
        return total

    def children(self, parent):
        return [s for s in self.spans if s.parent is parent]


class Span:
    """One timed interval of a request; its own context manager."""

    __slots__ = ("name", "start", "end", "parent", "request", "attrs",
                 "counts", "_token", "_range")

    def __init__(self, name: str, request, attrs):
        self.name = name
        self.request = request
        self.attrs = attrs
        self.start = self.end = None
        self.parent = None
        self.counts = None
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self):
        parent = _OPEN.get()
        if self.request is None and parent is not None:
            self.request = parent.request
        if parent is not None and parent.request == self.request:
            self.parent = parent
        record = _STORE.get(self.request)
        if record is not None:
            record.spans.append(self)
        self._token = _OPEN.set(self)
        self.start = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end = time.perf_counter_ns()
        _OPEN.reset(self._token)
        return False


def new_request() -> int:
    """A new request's id; the oldest beyond MAX_REQUESTS is dropped."""
    with _LOCK:
        rid = next(_IDS)
        _STORE[rid] = Request(rid)
        while len(_STORE) > MAX_REQUESTS:
            _STORE.popitem(last=False)
    return rid


def span(name: str, request=None, **attrs) -> Span:
    """A span of `request`, or of the innermost open span's request."""
    return Span(name, request, attrs)


def count(name: str, n: int = 1):
    """Add n to counter `name` of the innermost open span (if any)."""
    s = _OPEN.get()
    if s is not None:
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


def requests():
    """The recorded requests, oldest first."""
    with _LOCK:
        return list(_STORE.values())


def get(rid):
    """The recorded request `rid`, or None (never made, or dropped)."""
    with _LOCK:
        return _STORE.get(rid)


def proofs_between(start_s: float, end_s: float):
    """The requests whose `prove` span ended within [start_s, end_s]
    (seconds of time.perf_counter); LookupError if there is none."""
    lo, hi = start_s * 1e9, end_s * 1e9
    found = [r for r in requests()
             if any(s.end is not None and lo <= s.end <= hi
                    for s in r.find("prove"))]
    if not found:
        raise LookupError(f"no request's prove ended within "
                          f"[{start_s}, {end_s}] s")
    return found


class Sections:
    """Consecutive spans under the span open where the block starts:
    calling it with a name closes the span it opened last (after `on_close`,
    if given, has run inside that span) and opens the next; leaving the
    block closes the last one (on an exception without `on_close`).
    `spans` lists the spans it opened."""

    def __init__(self, on_close=None):
        self.on_close = on_close
        self.spans = []
        self._open = None

    def __call__(self, name: str, **attrs):
        self.close()
        self._open = Span(name, None, attrs).__enter__()
        self.spans.append(self._open)

    def close(self, failed: bool = False):
        s, self._open = self._open, None
        if s is not None:
            try:
                if self.on_close is not None and not failed:
                    self.on_close()
            finally:
                s.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.close(failed=exc_type is not None)
        return False


class Tally(collections.Counter):
    """A process-wide Counter the recorder owns: add(key, n) adds n under
    key, and n to counter `<prefix>.<key>` of the innermost open span."""

    def __init__(self, iterable=None, /, *, prefix: str = ""):
        super().__init__(iterable)
        self.prefix = prefix

    def add(self, key: str, n: int = 1):
        self[key] += n
        count(f"{self.prefix}.{key}", n)


TALLIES = {}


def tally(prefix: str) -> Tally:
    """The recorder's Tally called `prefix` (made on first use)."""
    if prefix not in TALLIES:
        TALLIES[prefix] = Tally(prefix=prefix)
    return TALLIES[prefix]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def to_device(x, device, name: str, pinned: bool = False):
    """x (a numpy array or a tensor) on `device`, in a span h2d.<name> that
    counts its bytes as h2d_bytes, whatever the device.  pinned: through
    pinned host memory, copied on the current stream with no synchronize
    (on a CUDA device)."""
    device = torch.device(device)
    with span("h2d." + name):
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) \
            else torch.as_tensor(x)
        count("h2d_bytes", _nbytes(t))
        if pinned and device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


def to_host(t, name: str):
    """The CPU tensor of t, in a span d2h.<name> that counts its bytes as
    d2h_bytes, whatever the device: a read of a CUDA tensor waits for the
    work queued before it."""
    with span("d2h." + name):
        count("d2h_bytes", _nbytes(t))
        return t.cpu()


def synchronize(device):
    """A phase-end device synchronize, in a span sync.phase (on a CUDA
    device)."""
    device = torch.device(device)
    if device.type == "cuda":
        with span("sync.phase"):
            torch.cuda.synchronize(device)
