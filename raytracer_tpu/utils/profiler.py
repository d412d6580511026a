"""Scoped-timer profiler registry, the `RT_SCOPED_TIMER` analogue.

The reference registers intrusive thread-local scoped timers and aggregates
min/avg/count per site (`Core/Utils/Profiler.h:25-102`); results feed the
demo's profiler panel.  Here:

- ``scoped_timer(name)`` / ``@profiled(name)`` time a host-side region with a
  monotonic high-resolution clock (`Core/Utils/Timer.*` analogue) and fold it
  into a process-global registry;
- ``collect()`` returns {name: {count, total, avg, min, max}} like
  ``Profiler::Collect``;
- ``device_trace(name)`` additionally opens a ``jax.profiler.TraceAnnotation``
  so the region shows up in xprof/perfetto device traces — the
  replacement for the reference's IACA marks (`Core/Utils/iacaMarks.h`).

Timed device work must be ``block_until_ready`` inside the scope to attribute
correctly (JAX dispatch is async); ``scoped_timer`` therefore measures
wall-clock of whatever the caller awaits, exactly like the reference's
``Timer`` wall measurements.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator

_lock = threading.Lock()
_registry: dict[str, dict] = {}


def reset() -> None:
    """Clear all collected timings."""
    with _lock:
        _registry.clear()


def _record(name: str, seconds: float) -> None:
    with _lock:
        e = _registry.get(name)
        if e is None:
            _registry[name] = {
                "count": 1, "total": seconds,
                "min": seconds, "max": seconds,
            }
        else:
            e["count"] += 1
            e["total"] += seconds
            e["min"] = min(e["min"], seconds)
            e["max"] = max(e["max"], seconds)


@contextmanager
def scoped_timer(name: str) -> Iterator[None]:
    """Time a region and fold it into the registry (`Profiler.h:96-102`)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


@contextmanager
def device_trace(name: str) -> Iterator[None]:
    """scoped_timer + xprof trace annotation for device timelines."""
    import jax.profiler

    with jax.profiler.TraceAnnotation(name):
        with scoped_timer(name):
            yield


def profiled(name: str | None = None) -> Callable:
    """Decorator form of ``scoped_timer``."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with scoped_timer(label):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


def collect() -> dict[str, dict]:
    """Aggregated stats per site: {name: {count,total,avg,min,max}} seconds."""
    with _lock:
        out = {}
        for name, e in _registry.items():
            out[name] = dict(e, avg=e["total"] / e["count"])
        return out


def report() -> str:
    """Human-readable table of collected timings."""
    stats = collect()
    if not stats:
        return "(no profiler samples)"
    width = max(len(n) for n in stats)
    lines = [f"{'scope':<{width}}  count     total      avg      min      max"]
    for name in sorted(stats, key=lambda n: -stats[n]["total"]):
        e = stats[name]
        lines.append(
            f"{name:<{width}}  {e['count']:5d}  {e['total']*1e3:8.2f}ms"
            f" {e['avg']*1e3:7.2f}ms {e['min']*1e3:7.2f}ms {e['max']*1e3:7.2f}ms"
        )
    return "\n".join(lines)


def start_device_profile(log_dir: str) -> None:
    """Begin an xprof capture (TensorBoard-viewable device trace)."""
    import jax.profiler

    jax.profiler.start_trace(log_dir)


def stop_device_profile() -> None:
    import jax.profiler

    jax.profiler.stop_trace()
