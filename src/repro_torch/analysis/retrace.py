"""Call-key guard for the port's batched DSE engines.

The JAX package's ``analysis/retrace.py`` counts each tracked ``jax.jit``'s
cache entries: the lru-cached engines must compile **once per (shape,
mesh)** — a silently retracing engine still produces bit-identical numbers
while quietly throwing away the batched stages' speedup.  The port has no
jit, no ``torch.compile`` and no CUDA graph, so there is no compile to
count; it keeps the *contract* instead.  ``track(name, fn,
static_argnames=...)`` returns a wrapper that records each call's key as
jit would key it — the shape, dtype and device type of every tensor or
array argument, the value of every argument named static, and the type of
any other argument — and ``compile_counts`` is the number of distinct keys
per name; ``call_counts`` says how many calls made each key.  A served chunk of a fixed width keeps its kernels at one shape,
and the guard proves it:

    with retrace_guard(expect=1) as g:
        run_surrogate_batched(cands, bound, trace, device="cpu")  # new key
    with retrace_guard(expect=0):
        run_surrogate_batched(cands, bound, trace, device="cpu")  # same key

The wrapper reads only the arguments' metadata: it launches nothing, moves
no launch and waits on no device.  The kernels' own builds (once per
process, ``kernels/build.py``) are not counted here.  Dependency-free: the
engine modules import ``track`` at module load.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

__all__ = ["track", "tracked_names", "compile_counts", "call_counts",
           "RetraceError", "RetraceGuard", "retrace_guard"]


class _Tracked:
    """One tracked callable and the calls it has seen, by call key."""

    def __init__(self, fn: Callable, static_argnames: Sequence[str]):
        self.fn = fn
        self.sig = inspect.signature(fn)
        self.static = frozenset(static_argnames)
        self.calls: Dict[Tuple, int] = {}

    def key(self, args, kwargs) -> Tuple:
        bound = self.sig.bind(*args, **kwargs)
        return tuple((name, value if name in self.static else _arg_key(value))
                     for name, value in bound.arguments.items())


def _arg_key(x: Any):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:          # tensor or array
        device = getattr(x, "device", None)
        return (tuple(shape), str(dtype),
                getattr(device, "type", None) or "cpu")
    return type(x).__name__


#: name -> tracked callable; names follow the JAX package's
#: ("surrogate.engine", "netsim.engine", "netsim.kernel.round1", ...)
_TRACKED: Dict[str, _Tracked] = {}


def track(name: str, fn: Callable, *,
          static_argnames: Sequence[str] = ()) -> Callable:
    """Register ``fn`` under a stable name and return a wrapper that records
    each call's key before calling it."""
    entry = _Tracked(fn, static_argnames)
    _TRACKED[name] = entry

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        key = entry.key(args, kwargs)
        entry.calls[key] = entry.calls.get(key, 0) + 1
        return fn(*args, **kwargs)

    return wrapper


def tracked_names():
    return sorted(_TRACKED)


def compile_counts() -> Dict[str, int]:
    """Distinct call keys per tracked engine, summable into a delta."""
    return {name: len(entry.calls) for name, entry in _TRACKED.items()}


def call_counts(name: str) -> Dict[Tuple, int]:
    """A tracked engine's calls so far by call key: each key a tuple of
    ``(argument name, value)``, a tensor's value ``(shape, dtype, device
    type)``.  Two snapshots show which keys a region called, new or not."""
    return dict(_TRACKED[name].calls)


class RetraceError(AssertionError):
    """An engine traced more (or less) than the contract allows."""


class RetraceGuard:
    """Before/after snapshot of every tracked engine's call keys."""

    def __init__(self):
        self._before = compile_counts()
        self._after: Optional[Dict[str, int]] = None

    def finish(self) -> None:
        self._after = compile_counts()

    def deltas(self) -> Dict[str, int]:
        """Per-engine new compiles since the guard opened (engines first
        tracked inside the guarded region count in full)."""
        after = self._after if self._after is not None else compile_counts()
        return {name: n - self._before.get(name, 0)
                for name, n in after.items()
                if n - self._before.get(name, 0) != 0}

    @property
    def new_compiles(self) -> int:
        return sum(self.deltas().values())


@contextlib.contextmanager
def retrace_guard(expect: Optional[int] = None):
    """Assert the guarded region compiled exactly ``expect`` new engine
    traces (``None`` = just observe; read ``.deltas()`` afterwards)."""
    guard = RetraceGuard()
    try:
        yield guard
    finally:
        guard.finish()
    if expect is not None and guard.new_compiles != expect:
        raise RetraceError(
            f"expected exactly {expect} new engine compile(s), got "
            f"{guard.new_compiles}: {guard.deltas() or '{}'}")
