"""Host-side frame-stack profiler plus JAX device-trace integration.

Parity with the reference ``profiling.py``: an interned frame tree,
stopwatches via contextvars, ``@profile_function`` decorators, a pluggable
profiler (Null / Flamegraph / Collect), and flamegraph.pl-format output.
Device-side tracing maps to ``jax.named_scope`` (visible in profiler
traces) instead of CUDA events/NVTX.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Dict, List, Optional, Tuple

import jax

_current_stack: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "katsdpimager_tpu_profile_stack", default=())


class Record:
    __slots__ = ("stack", "elapsed")

    def __init__(self, stack: Tuple[str, ...], elapsed: float):
        self.stack = stack
        self.elapsed = elapsed


class Profiler:
    """Base profiler: does nothing (NullProfiler semantics)."""

    _instance: "Profiler" = None  # set below

    @classmethod
    def set_profiler(cls, profiler: "Profiler"):
        cls._instance = profiler

    @classmethod
    def get_profiler(cls) -> "Profiler":
        return cls._instance

    def record(self, record: Record):
        pass


class CollectProfiler(Profiler):
    """Collects every record (for tests)."""

    def __init__(self):
        self.records: List[Record] = []

    def record(self, record: Record):
        self.records.append(record)


class FlamegraphProfiler(Profiler):
    """Aggregates exclusive time per stack for flamegraph.pl."""

    def __init__(self):
        self.inclusive: Dict[Tuple[str, ...], float] = {}

    def record(self, record: Record):
        self.inclusive[record.stack] = (
            self.inclusive.get(record.stack, 0.0) + record.elapsed)

    def exclusive(self) -> Dict[Tuple[str, ...], float]:
        out = dict(self.inclusive)
        for stack, elapsed in self.inclusive.items():
            if len(stack) > 1:
                parent = stack[:-1]
                if parent in out:
                    out[parent] -= elapsed
        return out

    def write_flamegraph(self, f):
        for stack, elapsed in sorted(self.exclusive().items()):
            if elapsed > 0:
                f.write(";".join(stack) + f" {int(elapsed * 1e6)}\n")


Profiler._instance = Profiler()


@contextlib.contextmanager
def profile(name: str):
    """Stopwatch context: times the block, tags device work with a JAX
    named_scope, and reports to the active profiler."""
    stack = _current_stack.get() + (name,)
    token = _current_stack.set(stack)
    start = time.monotonic()
    try:
        with jax.named_scope(name):
            yield
    finally:
        elapsed = time.monotonic() - start
        _current_stack.reset(token)
        Profiler.get_profiler().record(Record(stack, elapsed))


def profile_function(name: Optional[str] = None):
    """Decorator applying :func:`profile` around a function call."""

    def decorator(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with profile(label):
                return fn(*args, **kwargs)

        return wrapper

    return decorator


def device_trace(log_dir: str):
    """Start a JAX profiler trace (view with TensorBoard/XProf or
    Perfetto); it takes the place of the reference's NVTX/nsight
    ranges."""
    return jax.profiler.trace(log_dir)


def _kernel_line(line_name: str) -> bool:
    """Whether a line of a GPU plane (``/device:GPU:N``) holds one event
    per device kernel.

    ``Stream #...`` lines carry each kernel and copy as CUPTI recorded
    it; ``XLA Modules`` and ``XLA Ops`` lines, where a trace has them,
    are spans over the same time.  Only the stream lines are summed, so
    no time is counted twice."""
    return line_name.startswith("Stream")


def parse_device_profile(log_dir: str, platform: Optional[str] = None
                         ) -> Dict[Tuple[str, str], float]:
    """Aggregate per-kernel device time from a captured profiler trace.

    Reads the ``.xplane.pb`` files under ``log_dir`` (written by
    :func:`device_trace` / ``jax.profiler.trace``) and returns
    {(line_name, event_name): total_seconds} over the kernel lines of
    every device plane (:func:`_kernel_line`): the analogue of the
    reference's device-event records (``profiling.py:133-149``).  XLA op
    names carry the ``jax.named_scope`` prefixes that :func:`profile`
    installs, so the aggregation groups by pipeline stage.

    ``platform`` (default: JAX's) says where the traced run executed.  A
    CPU run has no device plane, and its host-side XLA executor lines are
    used instead; on an accelerator a trace without a device plane is an
    error, never a silent switch to host time.
    """
    import glob
    import os

    from jax.profiler import ProfileData

    if platform is None:
        platform = jax.devices()[0].platform
    totals: Dict[Tuple[str, str], float] = {}
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True))
    for path in files:
        pd = ProfileData.from_file(path)
        planes = list(pd.planes)
        device_planes = [p for p in planes if p.name.startswith("/device:")]
        if device_planes:
            line_filter = _kernel_line
        elif platform == "cpu":
            device_planes = [p for p in planes if p.name == "/host:CPU"]

            def line_filter(name):
                return "PjRt" in name or "xla" in name.lower()
        else:
            raise RuntimeError(
                f"{path}: no device plane in a trace of a {platform} run "
                f"(planes: {[p.name for p in planes]})")
        for plane in device_planes:
            for line in plane.lines:
                if not line_filter(line.name):
                    continue
                for ev in line.events:
                    dur = ev.duration_ns
                    if not dur:
                        continue
                    name = ev.name
                    if name.startswith(("ThreadpoolListener", "end:")):
                        continue
                    key = (line.name, name)
                    totals[key] = totals.get(key, 0.0) + dur * 1e-9
    return totals


def write_device_profile(totals: Dict[Tuple[str, str], float], f) -> None:
    """Write aggregated device times in flamegraph.pl format
    (``line;op microseconds``), largest first — the analogue of the
    reference's ``--write-device-profile`` output
    (``scripts/imager.py:89-92``)."""
    for (line, op), secs in sorted(totals.items(), key=lambda kv: -kv[1]):
        us = int(secs * 1e6)
        if us > 0:
            f.write(f"{line};{op} {us}\n")
