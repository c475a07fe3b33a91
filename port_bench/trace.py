"""Device trace of whole requests under torch.profiler.

A frozen copy of the reading in the port's `utils/timing.py`
(`profiled_kernels`, `idle_share`): the work is followed by a marker kernel
(`torch.neg`), and a profile that did not record the marker lost its device
activity and is not read.  Beside it:

  * spans: a metric may name functions of the port to wrap (its SPANS),
    each call in a `torch.profiler.record_function` named by the function
    (its site, `module.function`) and a tag the metric gives (for example
    the operator shape of a kernel launch).  A device operation belongs to
    every span open on the host when it was launched (its runtime call,
    matched by the CUPTI correlation id).  A site the port no longer has
    raises `TraceError`, and so does (in the harness) a metric's set of
    sites inside which no device work was launched: a function renamed or
    inlined does not take its kernels out of a metric's sight unnoticed;
  * host reads: `aten::_local_scalar_dense` events, the host's reads of
    single values from the card, each a stream synchronisation;
  * the breakdown: device time by operation name, and idle time by what the
    host launched to end each idle gap.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import torch

MARKER = "neg_kernel"
SPAN_PREFIX = "port_bench:"
HOST_READ = "aten::_local_scalar_dense"
TOP = 10


class TraceError(RuntimeError):
    """A span or a metric of a traced run found nothing to read."""


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    spans: Tuple[Tuple[str, str], ...] = ()   # (site, tag) of each open span, outermost first


@dataclass
class Trace:
    wall_s: float                 # host wall of the traced requests
    requests: int
    ops: List[DeviceOp]
    host_reads: int
    gaps: dict = field(default_factory=dict)   # idle seconds by what ended the gap

    @property
    def busy_s(self) -> float:
        """Seconds in which a device operation ran (the union of their spans)."""
        busy, end = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            a, b = op.start_ns, op.start_ns + op.dur_ns
            if end is None or a >= end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy * 1e-9

    def in_span(self, prefix: str) -> List[Tuple[DeviceOp, str]]:
        """(op, tag) for each op launched inside a span whose tag starts with
        `prefix` (the innermost such span)."""
        out = []
        for op in self.ops:
            tags = [t for _, t in op.spans if t.startswith(prefix)]
            if tags:
                out.append((op, tags[-1]))
        return out

    def launches_in(self, sites) -> int:
        """The device operations launched inside a span of any of `sites`."""
        return sum(any(site in sites for site, _ in op.spans) for op in self.ops)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0) + op.dur_ns
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:160], v * 1e-9] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


Span = Tuple[str, str, Callable[..., str]]   # (module, function, tag of its arguments)


def sites(spans: Sequence[Span]) -> set:
    """The `module.function` names of spans."""
    return {f"{mod}.{attr}" for mod, attr, _ in spans}


@contextlib.contextmanager
def wrapped(spans: Sequence[Span]):
    """Wrap each named function of the port in a record_function span for
    the duration of the block; a name the port does not have raises
    TraceError."""
    undo = []
    try:
        for mod_name, attr, tag in spans:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError as exc:
                raise TraceError(f"span {mod_name}.{attr}: no module {mod_name}") from exc
            orig = getattr(mod, attr, None)
            if orig is None:
                raise TraceError(f"span {mod_name}.{attr}: {mod_name} has no {attr}")
            site = f"{mod_name}.{attr}|"

            def wrapper(*a, _orig=orig, _tag=tag, _site=site, **k):
                with torch.profiler.record_function(SPAN_PREFIX + _site + _tag(*a, **k)):
                    return _orig(*a, **k)

            setattr(mod, attr, wrapper)
            undo.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced(call: Callable, n: int, device: torch.device, spans: Sequence[Span] = ()):
    """Run `call` n times under torch.profiler -> (results, Trace or None).
    None where the profile lost the device's activity (no marker) or no
    device ran (a CPU run)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    x = torch.ones(1024, device=device)
    results = []
    with wrapped(spans), profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            results.append(call())
            _sync(device)
        wall = time.perf_counter() - t0
        torch.neg(x)
        _sync(device)
    if device.type != "cuda":
        return results, None
    return results, read_events(prof.profiler.kineto_results.events(), wall, n)


def read_events(events, wall: float, n: int) -> Optional[Trace]:
    """A Trace from kineto events; None without the marker kernel."""
    dev, cpu = [], []
    for e in events:
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else cpu).append(e)
    marks = [e.start_ns() for e in dev if MARKER in e.name()]
    if not marks:
        return None
    mark = max(marks)
    # GPU-side copies of the benchmark's spans are not device work
    dev = [e for e in dev if e.start_ns() < mark and MARKER not in e.name()
           and not e.name().startswith(SPAN_PREFIX)]
    if not dev:
        return None
    # host side: runtime launches by correlation id, benchmark spans, ops
    launch, marks, ops_by_id, reads = {}, [], {}, 0
    for e in cpu:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            tag = tuple(name[len(SPAN_PREFIX):].split("|", 1))
            marks.append((e.start_ns(), 0, tag))
            marks.append((e.start_ns() + e.duration_ns(), 2, tag))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
        else:
            if e.correlation_id():
                ops_by_id[e.correlation_id()] = name
            reads += name == HOST_READ
    # the spans open at each launch: one sweep over opens, launches, closes
    for i, e in enumerate(dev):
        ts = launch.get(e.correlation_id())
        if ts is not None:
            marks.append((ts, 1, i))
    marks.sort(key=lambda m: (m[0], m[1]))
    open_tags: list = []
    tags_of = {}
    for _, kind, x in marks:
        if kind == 0:
            open_tags.append(x)
        elif kind == 2:
            open_tags.remove(x)
        else:
            tags_of[x] = tuple(open_tags)
    ops, hosts = [], []
    for i, e in enumerate(dev):
        ops.append(DeviceOp(e.name(), e.start_ns(), e.duration_ns(), tags_of.get(i, ())))
        linked = e.linked_correlation_id()
        hosts.append(ops_by_id.get(linked) if linked else None)
    order = sorted(range(len(ops)), key=lambda i: ops[i].start_ns)
    gaps: dict = {}
    end = None
    for i in order:
        op = ops[i]
        if end is not None and op.start_ns > end:
            host = hosts[i] or (op.spans[-1][1] if op.spans else "launch of " + op.name)
            gaps[host] = gaps.get(host, 0.0) + (op.start_ns - end) * 1e-9
        end = op.start_ns + op.dur_ns if end is None else max(end, op.start_ns + op.dur_ns)
    return Trace(wall_s=wall, requests=n, ops=[ops[i] for i in order], host_reads=reads,
                 gaps=gaps)
