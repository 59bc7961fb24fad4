"""The port's tracer: host spans, device spans on the host's clock, and the
stages the NUTS doubling's own kernels stamp inside their CUDA graphs
(WHILE bodies included). Off by default.

    from ..utils import trace
    trace.start()                        # synchronises the card, anchors its clock
    with trace.span("name"):             # a host span
        ...
    rep = trace.report()                 # reads the device once
    trace.stop()

One process-wide ``Tracer`` (``TRACER``); the module's functions are its
methods. Off, ``span``, ``device_span``, ``section`` and ``stage`` return
one shared no-op object: the caller reads no clock, records no event,
allocates nothing and launches nothing. ``timed`` and ``phase`` always
read the clock (``solve_magi``'s ``phase_times_s``, the samplers' warmup
and sampling seconds, the trees' capture seconds) and are recorded as
spans too while the tracer is on.

Host spans. Each records its name, its start and end (``clock``,
``time.perf_counter_ns``), its parent and the transition it belongs to (the
index of the enclosing ``transition`` span, -1 outside one), and a count
(``count``: the leaves a doubling's readout reports).

Device spans. On a CUDA device a ``device_span`` also records a pair of
timing CUDA events around its work on the current stream: ``kind`` "graph"
for a doubling's graph replay, "eager" for the transition's eager kernels.
``start`` synchronises, reads the clock and records an anchor event; an
event's time is the anchor's host time plus ``elapsed_time(anchor,
event)``. Events are read in ``report`` only.

Stages inside the doubling graphs. While the tracer is on, the port's own
kernels of a doubling are launched, and captured, with the address of a
small device buffer (``stamp``, int64 [the last stamp's ns, the stage it
opened, the first stamp's ns, ns by stage, entries by stage]): D1, L2, D2
(``ops/leaf.py``) and the first ``minv_mv`` launch inside a ``stage`` scope
(``ops/minv_mv.py``: the whitening GEMM that opens the value-and-grad, and
the metric's M^-1 g). Given it, a launch runs the kernel's traced
instantiation: one thread of block 0 reads ``%globaltimer`` on entry and,
with atomics it does not wait on, closes the stage before it (adds the
time, counts an entry) and opens its own (subtracts the time), so a
stage's sum is its ends less its starts. The stage a stamp closes is
fixed at the launch or the capture: the tracer follows the order of the
stamping launches. D2 stamps ``between_graphs`` again on exit, in the
block that arrives last. ``report`` closes the stage open at the last
stamp and drops the first stamp's unmatched close. The stages
(``STAGES``): ``open`` D1, ``vg`` the value-and-grad, ``metric`` M^-1 g,
``commit`` L2 and the WHILE node's condition, ``merge`` D2,
``between_graphs`` from D2's exit to the next D1 (the gap between
replays, the next graph's launch and its random draws). A stage whose
first kernel is not the port's (a cuBLAS GEMM, autograd, a diagonal or
per-rung metric's product) is never stamped: its time falls to the stage
before it, which ``report()["merged"]`` names. The stamps add no graph
node, change no value and draw nothing; graphs captured while the tracer
is off hold a null address and run the untraced kernels. The buffer is
made once per device and kept, so a graph captured while the tracer was
on stamps it ever after; ``start`` zeroes it in place.

``report`` gives per span name the count, total and self seconds and the
summed counts; per section (``"all"``, from ``start`` to now or ``stop``,
and the last span opened with ``section(name)``) its spans' seconds by
name, the device's time in graph replays (``busy_s``) and in the eager
spans (``eager_s``: from the first eager kernel's start to the last one's
end, so the launch gaps between them count too), the gaps between one
graph's end and the next one's start within a transition
(``doubling_gap``) and from a transition's last graph to the next one's
first (``transition_gap``, split into eager spans and idle), each idle
stretch put down to the innermost host span open over it (``caller``
where none is), the stages' sums, the replays' time outside every stamped
stage (the graph's launch latency and draws), and the per-leaf and
per-doubling readings built from them (``metrics``); and
``warmup_adapt_s``, the warmup's seconds outside ``warmup.transition``
(captures inside one count as adaptation's). ``write_chrome`` writes the
spans, the device spans and the stage sums as a Chrome trace.
"""
from __future__ import annotations

import bisect
import json
import time
from typing import Optional

import torch

STAGES = ("open", "vg", "metric", "commit", "merge", "between_graphs")
OPEN, VG, METRIC, COMMIT, MERGE, BETWEEN = range(len(STAGES))
# the device buffer: [the last stamp's ns, the stage it opened, the first
# stamp's ns, ns by stage, entries by stage]
LAST, CURRENT, FIRST, SUMS = range(4)
STAMP_WORDS = SUMS + 2 * len(STAGES)
CALLER = "caller"
_NS = 1e-9


def clock() -> int:
    """The tracer's host clock, ns."""
    return time.perf_counter_ns()


class _NoSpan:
    """The shared no-op span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, n) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    """A recorded span: name, host start and end (ns), parent (its index in
    the tracer's list, -1 at the top), transition, count, and for a device
    span its kind and event pair; a section holds the stamp buffer's copies
    at its start and end."""

    __slots__ = ("tracer", "name", "start", "end", "parent", "transition", "n", "kind",
                 "events", "snaps", "index")

    def __init__(self, tracer, name, kind=None, section=False):
        self.tracer, self.name, self.kind = tracer, name, kind
        self.end, self.n, self.events = None, 0, None
        self.snaps = [] if section else None

    def __enter__(self):
        t = self.tracer
        stack = t.stack
        self.parent = stack[-1].index if stack else -1
        if self.name == "transition":
            t.transition = t.n_transitions
            t.n_transitions += 1
        self.transition = t.transition
        self.index = len(t.spans)
        t.spans.append(self)
        stack.append(self)
        if self.snaps is not None:
            self.snaps.append(t._snapshot())
        self.start = clock()
        if self.kind is not None and t.device is not None:
            self.events = (t._event(), None)
        return self

    def __exit__(self, *exc):
        t = self.tracer
        if self.events is not None:
            self.events = (self.events[0], t._event())
        self.end = clock()
        if self.snaps is not None:
            self.snaps.append(t._snapshot())
        t.stack.pop()
        if self.name == "transition":
            t.transition = -1
        return False

    def count(self, n) -> None:
        self.n += int(n)


class Timed:
    """A span whose seconds are read whether the tracer is on or not
    (``seconds`` after it closes), recorded as a span while it is on; with
    ``into`` its seconds are added to ``into[key]``."""

    __slots__ = ("tracer", "name", "into", "key", "t0", "seconds", "span")

    def __init__(self, tracer, name, into=None, key=None):
        self.tracer, self.name, self.into, self.key = tracer, name, into, key
        self.seconds = 0.0

    def __enter__(self):
        self.span = self.tracer.span(self.name).__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        self.seconds = (clock() - self.t0) * _NS
        self.span.__exit__(*exc)
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + self.seconds
        return False


class _Stage:
    """The scope in which the next stamping kernel launched stamps
    ``stage``."""

    __slots__ = ("tracer", "stage")

    def __init__(self, tracer, stage):
        self.tracer, self.stage = tracer, stage

    def __enter__(self):
        self.tracer.pending = self.stage
        return self

    def __exit__(self, *exc):
        self.tracer.pending = None
        return False


_BUFFERS = {}  # device -> the stamp buffer, made once and kept (graphs hold its address)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # CUDA builds


class Tracer:
    """See the module docstring."""

    def __init__(self):
        self.on = False
        self.device = None
        self._clear()

    def _clear(self):
        self.spans, self.stack = [], []
        self.transition, self.n_transitions = -1, 0
        self.pending = None
        self.stamped, self.last_stage = set(), BETWEEN
        self.stream = self.raw_stream = None
        self.anchor = None
        self.t_start = self.t_stop = None

    # -- switching ------------------------------------------------------------

    def start(self, device=None) -> None:
        """Start a new trace (dropping the last one): on ``device`` (by
        default the current CUDA device where there is one) the stamp buffer
        is made or zeroed, the card synchronised and its clock anchored."""
        self._clear()
        dev = None
        if device is not None and torch.device(device).type == "cuda":
            dev = torch.device(device)
        elif device is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev is not None and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if dev is not None:
            buf = _BUFFERS.get(dev)
            if buf is None:
                buf = _BUFFERS[dev] = torch.zeros(STAMP_WORDS, dtype=torch.int64, device=dev)
            buf.zero_()
            ev = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            t0 = clock()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
            self.anchor = ((t0 + clock()) // 2, ev)
        self.t_start = clock()
        self.on = True

    def stop(self) -> None:
        """Stop recording; what was recorded stays for ``report``."""
        if self.on:
            self.t_stop = clock()
            self.on = False

    def enabled(self) -> bool:
        return self.on

    # -- recording ------------------------------------------------------------

    def span(self, name: str):
        """A host span named ``name`` (a context manager)."""
        return _Span(self, name) if self.on else NO_SPAN

    def device_span(self, name: str, kind: str = "eager"):
        """A host span that on a CUDA device also records a timing event
        pair around its work on the current stream: ``kind`` "graph" (a
        doubling's replay) or "eager"."""
        return _Span(self, name, kind) if self.on else NO_SPAN

    def section(self, name: str):
        """A span over which ``report`` gives a section of its own (the stamp
        buffer is copied, on the stream, at both ends)."""
        return _Span(self, name, section=True) if self.on else NO_SPAN

    def timed(self, name: str) -> Timed:
        """A span timed whether the tracer is on or not (``.seconds``)."""
        return Timed(self, name)

    def phase(self, times: dict, key: str) -> Timed:
        """``timed`` span ``phase.<key>`` whose seconds add to
        ``times[key]`` (``solve_magi``'s ``phase_times_s``)."""
        return Timed(self, "phase." + key.removesuffix("_s"), times, key)

    def stage(self, stage: int):
        """The scope in which the first ``minv_mv`` launch stamps ``stage``."""
        return _Stage(self, stage) if self.on and self.device is not None else NO_SPAN

    def stamp(self, device, stage: int):
        """(the stamp buffer's address, the stage the stamp closes) for a
        launch on ``device`` of a kernel that stamps ``stage``, or (None, 0)
        (off, or not this card). D1 (``open``) closes ``between_graphs``
        and D2 leaves ``between_graphs`` open, whatever came before."""
        if not self.on or self.device is None or torch.device(device) != self.device:
            return None, 0
        self.stamped.add(stage)
        prev = BETWEEN if stage == OPEN else self.last_stage
        self.last_stage = BETWEEN if stage == MERGE else stage
        return _BUFFERS[self.device].data_ptr(), prev

    def take_stage(self, device):
        """(address, the stage it closes, stage) of the ``stage`` scope open,
        which this launch takes, or (None, 0, 0)."""
        stage = self.pending
        if stage is None:
            return None, 0, 0
        self.pending = None
        return (*self.stamp(device, stage), stage)

    def _event(self):
        """A timing event recorded on the current stream. The stream object
        is kept while the current stream stays the same (asking torch for
        it costs several microseconds a call)."""
        raw = _RAW_STREAM(self.device.index) if _RAW_STREAM is not None else None
        if raw is None or raw != self.raw_stream:
            self.raw_stream, self.stream = raw, torch.cuda.current_stream(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def _snapshot(self):
        if self.device is None:
            return None
        return _BUFFERS[self.device].clone()

    # -- reading ----------------------------------------------------------------

    def _device_times(self) -> dict:
        """Host ns (start, end) of every device span, by span index."""
        if self.anchor is None:
            return {}
        torch.cuda.synchronize(self.device)
        host0, ev0 = self.anchor
        out = {}
        for sp in self.spans:
            if sp.events is not None and sp.events[1] is not None:
                a, b = (host0 + int(1e6 * ev0.elapsed_time(e)) for e in sp.events)
                out[sp.index] = (a, b)
        return out

    def _stage_sums(self, first, last) -> Optional[dict]:
        """Stage seconds and entries between two copies of the buffer (or
        from zero)."""
        if last is None:
            return None
        a, b = _closed(first), _closed(last)
        k = len(STAGES)
        return {name: {"s": (b[i] - a[i]) * _NS, "hits": b[k + i] - a[k + i]}
                for i, name in enumerate(STAGES)}

    def merged(self) -> dict:
        """Each stage no kernel stamped, with the stage its time falls to (in
        a leaf's order vg, metric, commit; leaf 0's vg falls to open). D1,
        L2 and D2 always stamp."""
        if not self.stamped:
            return {}
        out = {}
        if VG not in self.stamped:
            out["vg"] = "commit"
        if METRIC not in self.stamped:
            out["metric"] = "vg" if VG in self.stamped else "commit"
        return out

    def report(self) -> dict:
        """See the module docstring (empty before the first ``start``)."""
        return self._report(self._device_times()) if self.t_start is not None else {}

    def _report(self, dev) -> dict:
        end = clock() if self.on else self.t_stop
        names = {}
        child = [0] * len(self.spans)
        for sp in self.spans:
            stop = sp.end if sp.end is not None else end
            if sp.parent >= 0:
                child[sp.parent] += stop - sp.start
        for sp in self.spans:
            stop = sp.end if sp.end is not None else end
            e = names.setdefault(sp.name, {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                           "counted": 0})
            e["count"] += 1
            e["total_s"] += (stop - sp.start) * _NS
            e["self_s"] += (stop - sp.start - child[sp.index]) * _NS
            e["counted"] += sp.n
        sections = {"all": self._section(self.t_start, end, dev, self._stage_sums(
            None, self._snapshot()))}
        for sp in self.spans:
            if sp.snaps is not None and sp.end is not None:
                sections[sp.name] = self._section(sp.start, sp.end, dev, self._stage_sums(
                    *sp.snaps))
        return {"spans": names, "sections": sections, "stages": list(STAGES),
                "merged": self.merged(), "warmup_adapt_s": self._warmup_adapt(end)}

    def _warmup_adapt(self, end) -> Optional[float]:
        """Warmup seconds outside ``warmup.transition``, with the captures
        made inside one."""
        spans = self.spans
        warm = [sp for sp in spans if sp.name == "warmup"]
        if not warm:
            return None

        def dur(sp):
            return ((sp.end if sp.end is not None else end) - sp.start) * _NS

        def within(sp, name):
            i = sp.parent
            while i >= 0:
                if spans[i].name == name:
                    return True
                i = spans[i].parent
            return False

        total = sum(dur(sp) for sp in warm)
        trans = sum(dur(sp) for sp in spans
                    if sp.name == "warmup.transition" and within(sp, "warmup"))
        caps = sum(dur(sp) for sp in spans
                   if sp.name == "tree.capture" and within(sp, "warmup.transition"))
        return total - trans + caps

    def _section(self, t0, t1, dev, stages) -> dict:
        inside = [sp for sp in self.spans
                  if sp.start >= t0 and (sp.end if sp.end is not None else t1) <= t1]
        graphs = sorted((dev[sp.index] + (sp.transition,)) for sp in inside
                        if sp.kind == "graph" and sp.index in dev)
        eager = _union(dev[sp.index] for sp in inside if sp.kind == "eager" and sp.index in dev)
        ends = [b for _, b in eager]
        out = {"wall_s": (t1 - t0) * _NS,
               "transitions": sum(sp.name == "transition" for sp in inside),
               "doublings": sum(sp.name == "doubling.launch" for sp in inside),
               "leaves": sum(sp.n for sp in inside if sp.name == "doubling.readout"),
               "replays": len(graphs),
               "busy_s": sum(b - a for a, b, _ in graphs) * _NS,
               "eager_s": sum(b - a for a, b in eager) * _NS}
        d_gaps, t_gaps, t_eager = [], [], 0
        for (_, b, tr), (a, _, tr2) in zip(graphs, graphs[1:]):
            if tr == tr2 and tr >= 0:
                d_gaps.append(a - b)
            else:
                t_gaps.append(a - b)
                t_eager += _eager_within(eager, ends, b, a)
        out.update(doubling_gaps=len(d_gaps), doubling_gap_s=sum(d_gaps) * _NS,
                   transition_gaps=len(t_gaps), transition_gap_s=sum(t_gaps) * _NS,
                   transition_gap_eager_s=t_eager * _NS,
                   transition_gap_idle_s=(sum(t_gaps) - t_eager) * _NS)
        if dev:
            idle = _complement(_union([g[:2] for g in graphs] + eager), t0, t1)
            hosts = [sp for sp in self.spans if sp.snaps is None]
            by_span = _attribute(idle, _innermost(hosts, t1))
            out["idle_s"] = sum(b - a for a, b in idle) * _NS
            out["idle_by_span"] = {k: v * _NS for k, v in
                                   sorted(by_span.items(), key=lambda kv: -kv[1])}
        if stages is not None:
            out["stages"] = stages
            # the replays' time in which no stamped stage ran: the graphs'
            # launch latency, their two draws, and the events' own edges
            out["replay_outside_stages_s"] = out["busy_s"] - sum(
                stages[name]["s"] for name in STAGES[:BETWEEN]) if graphs else 0.0
        totals = {}
        for sp in inside:
            if sp.snaps is None:
                stop = sp.end if sp.end is not None else t1
                totals[sp.name] = totals.get(sp.name, 0.0) + (stop - sp.start) * _NS
        out["span_s"] = totals
        out["metrics"] = _readings(out, stages, self.merged())
        return out

    # -- export -------------------------------------------------------------------

    def write_chrome(self, path: str, rank: int = 0) -> dict:
        """The spans (host, pid 0) and device spans (pid 1) as a Chrome trace
        at ``path``, in microseconds from the trace's start, with the
        report's stage sums and readings in ``otherData``. Returns the
        report."""
        dev = self._device_times()
        rep = self._report(dev)
        t0 = self.t_start
        us = lambda ns: (ns - t0) / 1e3  # noqa: E731
        end = self.t_stop or clock()
        events = [{"name": "process_name", "ph": "M", "pid": p, "args": {"name": n}}
                  for p, n in ((0, f"host rank {rank}"), (1, f"device rank {rank}"))]
        for sp in self.spans:
            stop = sp.end if sp.end is not None else end
            args = {"transition": sp.transition}
            if sp.n:
                args["count"] = sp.n
            events.append({"name": sp.name, "ph": "X", "pid": 0, "tid": 0, "ts": us(sp.start),
                           "dur": (stop - sp.start) / 1e3, "args": args})
            if sp.index in dev:
                a, b = dev[sp.index]
                events.append({"name": f"{sp.name} ({sp.kind})", "ph": "X", "pid": 1,
                               "tid": 0 if sp.kind == "graph" else 1, "ts": us(a),
                               "dur": (b - a) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"sections": rep["sections"], "merged": rep["merged"]}}, f)
        return rep


def _closed(buf) -> list:
    """A copy of the stamp buffer as [ns by stage, entries by stage] with
    the stage open at the last stamp closed there (so it adds nothing) and
    the first stamp's close of ``between_graphs``, which no open matched,
    taken out; zeros for None."""
    k = len(STAGES)
    if buf is None:
        return [0] * (2 * k)
    b = buf.cpu().tolist()
    out = b[SUMS:SUMS + 2 * k]
    if b[LAST]:
        out[b[CURRENT]] += b[LAST]
    if b[FIRST]:
        out[BETWEEN] -= b[FIRST]
        out[k + BETWEEN] -= 1
    return out


def _union(intervals) -> list:
    """The sorted disjoint union of (start, end) stretches."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _complement(busy, t0, t1) -> list:
    """The stretches of [t0, t1] outside the sorted disjoint ``busy``."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def _innermost(spans, t1) -> list:
    """(start, end, name) stretches in which ``name`` is the innermost span
    open; nested spans only (one host thread)."""
    cuts = []
    for sp in spans:
        cuts.append((sp.start, 1, sp.index, sp.name))
        cuts.append((sp.end if sp.end is not None else t1, 0, sp.index, sp.name))
    cuts.sort()
    out, stack, at = [], [], None
    for t, opening, _, name in cuts:
        if at is not None and t > at:
            out.append((at, t, stack[-1] if stack else CALLER))
        at = t
        if opening:
            stack.append(name)
        elif stack:
            stack.pop()
    return out


def _attribute(idle, pieces) -> dict:
    """Idle ns by the innermost span over each stretch (``pieces``, sorted
    and disjoint), ``caller`` where no span is open."""
    out, j = {}, 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k, covered = j, 0
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[CALLER] = out.get(CALLER, 0) + b - a - covered
    return out


def _eager_within(eager, ends, lo, hi) -> int:
    """ns of the sorted disjoint ``eager`` stretches (``ends`` their ends)
    inside [lo, hi]."""
    total, i = 0, bisect.bisect_right(ends, lo)
    while i < len(eager) and eager[i][0] < hi:
        total += max(min(eager[i][1], hi) - max(eager[i][0], lo), 0)
        i += 1
    return total


def _readings(sec, stages, merged) -> dict:
    """A section's readings: device ms per batched leaf in the stages
    ``vg``, ``metric`` and ``commit``, per doubling in ``open`` + ``merge``,
    per gap between graphs within a transition and between transitions (its
    eager and idle parts), each where it was measured."""
    out = {}
    if stages:
        leaves, doublings = stages["commit"]["hits"], stages["open"]["hits"]
        for name in ("vg", "metric", "commit"):
            if leaves and name not in merged:
                out[f"{name}_in_tree_ms"] = 1e3 * stages[name]["s"] / leaves
        if doublings:
            out["doubling_ends_ms"] = 1e3 * (stages["open"]["s"] + stages["merge"]["s"]) \
                / doublings
    if sec["doubling_gaps"]:
        out["doubling_gap_ms"] = 1e3 * sec["doubling_gap_s"] / sec["doubling_gaps"]
    if sec["transition_gaps"]:
        n = sec["transition_gaps"]
        out["transition_gap_ms"] = 1e3 * sec["transition_gap_s"] / n
        out["transition_gap_eager_ms"] = 1e3 * sec["transition_gap_eager_s"] / n
        out["transition_gap_idle_ms"] = 1e3 * sec["transition_gap_idle_s"] / n
    return out


TRACER = Tracer()
start, stop, enabled, report = TRACER.start, TRACER.stop, TRACER.enabled, TRACER.report
span, device_span, section, timed, phase = (TRACER.span, TRACER.device_span, TRACER.section,
                                            TRACER.timed, TRACER.phase)
stage, stamp, take_stage, write_chrome = (TRACER.stage, TRACER.stamp, TRACER.take_stage,
                                          TRACER.write_chrome)
