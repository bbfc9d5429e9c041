"""Spans and counters of the port: where the host's time goes, layer by layer, and what each layer launched.

``span(name, **attrs)`` is a context manager that records only while a ``torch.profiler`` profile is active in
this process (the probe ``torch._C._autograd._profiler_enabled()``, a fraction of a microsecond).  With nothing
profiling it returns one shared null context and records nothing, so a span site costs the probe.  A record
holds:

* the span's name and attributes;
* its start and end from ``time.perf_counter_ns()``, the clock ``time.perf_counter`` reads;
* its parent: the innermost span open on its thread, or, on a thread with none open (autograd's device thread
  running a backward), the innermost span open on the thread of the current root (``loss.backward``);
* its thread, and the index of its root span, which names the unit of work it belongs to.

``timed(name, **attrs)`` is a span that always measures itself (``.seconds``), for the callers that log or
record its time (the fit's stage seconds, the tracker's ``*_time`` metrics); it records like ``span``.

Records stay in memory, at most ``CAP`` of them; what does not fit is counted (``dropped()``).  ``spans()``
reads them, ``clear()`` empties them and the counters.  Inside ``named()`` (the runner's ``other.profile``)
every recording span also opens a ``torch.profiler.record_function`` range of its name, its attributes' values
in brackets (``ops.launch[lin_lookup_fwd]``), so that a user's trace shows the layers and the port's launches;
outside it no range is opened.

``count(name, n=1)`` is always on (an integer add): ``ops.launches[<C function>]`` (``ops.build.launch``)
and ``tracker.bytes`` (``utils.mlflow_shim``).  ``counters()`` reads them.

PERF.md lists every span and counter of the port with the metric or the record key that reads it.
"""

import contextlib
import threading
import time

import torch

CAP = 1 << 18

_profiling = torch._C._autograd._profiler_enabled
# the records, one list a field: ints and strings, which Python's cyclic GC does not track, and one shared dict for
# each distinct set of attributes, so that recording adds nothing for a full collection to walk and does not
# bring one forward into the traced work
_FIELDS = ("name", "attrs", "start", "end", "parent", "root", "thread")
_records = {field: [] for field in _FIELDS}
_shared_attrs = {}
_counters = {}
_lock = threading.Lock()
_local = threading.local()
_state = {"root_stack": None, "named": 0, "dropped": 0}


class Span:
    """One span: a context manager that times itself and, with ``record``, adds itself to the records."""

    __slots__ = ("name", "attrs", "start", "end", "root", "index", "_record", "_range")

    def __init__(self, name, attrs, record):
        self.name, self.attrs, self._record = name, attrs, record
        self.start = self.end = self.root = self.index = self._range = None

    @property
    def seconds(self):
        """Its duration; while it is open, the seconds so far."""
        return ((time.perf_counter_ns() if self.end is None else self.end) - self.start) * 1e-9

    def __enter__(self):
        if self._record:
            self._open()
        self.start = time.perf_counter_ns()
        if self.index is not None:
            _records["start"][self.index] = self.start
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._record:
            if self.index is not None:
                _records["end"][self.index] = self.end
            if self._range is not None:
                self._range.__exit__(*exc)
            self._stack().pop()
        return False

    @staticmethod
    def _stack():
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        return stack

    def _open(self):
        stack = self._stack()
        if stack:
            parent = stack[-1]
        else:
            root_stack = _state["root_stack"]
            try:  # a thread with no span open of its own takes the root's thread's innermost one
                parent = root_stack[-1] if root_stack is not None and root_stack is not stack else None
            except IndexError:  # the root closed meanwhile
                parent = None
        if self.attrs:
            key = tuple(self.attrs.items())
            self.attrs = _shared_attrs.setdefault(key, self.attrs)
        with _lock:
            if parent is not None and parent.index is None or len(_records["name"]) >= CAP:
                _state["dropped"] += 1
            else:
                self.index = len(_records["name"])
                self.root = self.index if parent is None else parent.root
                values = (self.name, self.attrs or None, None, None, None if parent is None else parent.index,
                          self.root, threading.get_ident())
                for field, value in zip(_FIELDS, values):
                    _records[field].append(value)
        if self.index is not None:
            if parent is None:
                _state["root_stack"] = stack
            if _state["named"]:
                label = f"{self.name}[{','.join(map(str, self.attrs.values()))}]" if self.attrs else self.name
                self._range = torch.profiler.record_function(label)
                self._range.__enter__()
        stack.append(self)


_NULL = contextlib.nullcontext()


def span(name, **attrs):
    """A span of ``name``: recorded while a profiler is active, else the shared null context."""
    return Span(name, attrs, True) if _profiling() else _NULL


def timed(name, **attrs):
    """A span of ``name`` that always measures its ``.seconds``; recorded while a profiler is active."""
    return Span(name, attrs, _profiling())


def count(name, n=1):
    _counters[name] = _counters.get(name, 0) + n


def counters():
    """{counter: value} since the process started or the last ``clear()``."""
    return dict(_counters)


def spans():
    """The records, in the order the spans opened: dicts of ``index``, ``name``, ``attrs``, ``start_ns``,
    ``end_ns`` (None while open), ``parent`` (an index or None), ``root`` (an index) and ``thread``."""
    r = _records
    return [{"index": i, "name": r["name"][i], "attrs": dict(r["attrs"][i] or {}), "start_ns": r["start"][i],
             "end_ns": r["end"][i], "parent": r["parent"][i], "root": r["root"][i], "thread": r["thread"][i]}
            for i in range(len(r["name"]))]


def dropped():
    """The spans left out since the last ``clear()``: the records were full, or their parent was left out."""
    return _state["dropped"]


def clear():
    """Empty the records and the counters."""
    with _lock:
        for field in _records.values():
            field.clear()
        _state["dropped"] = 0
    _counters.clear()


@contextlib.contextmanager
def named():
    """While open, each recording span also opens a ``torch.profiler.record_function`` range of its name."""
    _state["named"] += 1
    try:
        yield
    finally:
        _state["named"] -= 1
