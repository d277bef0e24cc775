"""Spans and counters at the package's layer boundaries, kept in memory.

Off, the default, a span is one test of a module flag that returns a shared
no-op context manager, and a counter is the same test: nothing is timed,
allocated or recorded.  :func:`enable` turns recording on, :func:`disable`
off; :func:`take` returns what was recorded and clears it.

On, each span appends one record: its name, its start and end
(``time.perf_counter_ns``), the index of its parent in the records (None for
a span opened with no parent) and a root id that a span with no parent
takes and all its descendants share, so the spans of one call group
together.  While a ``torch.profiler`` session is active, a span also opens
``record_function("tabmat_torch/<name>")``, which puts it in the profiler's
trace beside the kernels it launches, on the trace's clock.

Counters: ``plans_built`` (segment plans, ``ops/segments.py``) and, of
them, ``plans_from_device_keys`` (built from keys already on the plan's
device, with no upload), ``tables_built`` (kernel tables built at a plan's
first call on the card, ``ops/segsum_kernel.py``, ``ops/spmv_kernel.py`` and
``ops/sparse_gram_kernel.py``),
``steps`` (Newton steps, ``glm.py``), ``cg_graph_captures`` and
``cg_graph_replays`` (the CUDA graphs of the explicit-Hessian CG solve
captured, and replayed, ``glm._cg_solve_dense``), ``hvp_steps`` and ``hvp``
(the Newton steps on the Hessian-vector route of ``glm.irls_step``, and the
Hessian-vector products their CG solves run), ``hvp_graph_captures`` and
``hvp_graph_replays`` (the CUDA graphs of that solve captured, once a design
and key, and replayed, once a step on the card, ``glm._cg_solve_hvp``),
``hvp_route.standardized``,
``hvp_route.wide`` and ``hvp_route.plan`` (one a step on that route for each
reason ``DeviceDesign.sandwich_refusals`` gives), ``sparse_gram`` (the
``SparseMatrix`` sandwiches the sparse Gram kernel serves,
``models/sparse.py``),
``sparse_panels`` and ``sparse_panel_bytes`` (the row panels a
``SparseMatrix`` sandwich densifies, and their bytes), and ``std_sandwich``,
``std_expand_kernel`` and ``std_rank1_bytes`` (``StandardizedMatrix``
sandwiches, those whose expansion the ``std_expand<T>`` kernel serves, and
the bytes of the (k, k) temporaries their rank-1 expansion allocates,
``models/standardized.py``, whose spans are ``std.matvec``, ``std.tmv`` and
``std.sandwich`` > ``std.sandwich.inner``, ``std.sandwich.rank1``).  Kernel
launches are counted by the wrappers' ``launches`` dicts.

Spans are ``with`` blocks inside function bodies, never wrappers: a frame
more would move what ``from_formula(context=<int>)`` reads.
"""

import contextlib
import threading
import time

import torch

PREFIX = "tabmat_torch/"

_enabled = False
_NOOP = contextlib.nullcontext()
# (id, name, start_ns, end_ns, parent id, root id) of each span, appended as
# it closes: tuples of numbers and strings, which the garbage collector
# stops scanning
_records = []
_counters = {}
_local = threading.local()  # each thread's stack of open spans
_opened = 0  # spans opened since the last take(): the next span's id
_roots = 0  # root ids handed out so far


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "ranged")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _opened, _roots
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = _opened
        _opened += 1
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, _roots
            _roots += 1
        stack.append(self)
        self.ranged = None
        if torch.autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(PREFIX + self.name)
            self.ranged.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        _local.stack.pop()
        _records.append((self.id, self.name, self.start, end, self.parent, self.root))
        return False


def span(name: str):
    """A context manager that records the block as the span ``name``."""
    if not _enabled:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _enabled:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _enabled


def enable() -> None:
    """Start recording spans and counters."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`take`."""
    global _enabled
    _enabled = False


def take() -> dict:
    """``{"spans": [...], "counters": {...}}`` recorded since the last call,
    and clear them.  Each span is a dict with ``name``, ``start_ns``,
    ``end_ns``, ``parent`` (an index into the list, or None) and ``root``;
    the list is in the order the spans opened.  Call it with no span open."""
    global _opened
    if getattr(_local, "stack", None):
        raise RuntimeError("take() with a span open")
    spans = [{"name": n, "start_ns": s, "end_ns": e, "parent": p, "root": r}
             for _, n, s, e, p, r in sorted(_records)]
    counters = dict(_counters)
    _records.clear()
    _counters.clear()
    _opened = 0
    return {"spans": spans, "counters": counters}
