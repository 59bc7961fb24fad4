"""What a traced run (``--trace 1``) reads besides the program's own
counters and spans: the device's busy time in the window from CUDA events
around every CUDA-graph replay (the profiler misses kernels inside a WHILE
node's body, so it cannot give it), and device times of the value-and-grad
and of single kernels at the cell's shapes, each from CUDA events around a
replayed CUDA graph of many calls."""
from __future__ import annotations

import torch

GRAPH_CALLS = 100
GRAPH_REPLAYS = 5


class ReplaySpans:
    """Inside the context every ``torch.cuda.CUDAGraph.replay`` is
    bracketed by two CUDA events on the current stream; ``seconds`` gives
    each replay's span. Every replay of the port's tree is
    followed by a host read, so a span holds its own graph's work alone."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        self.replay = torch.cuda.CUDAGraph.replay
        events, replay = self.events, self.replay

        def timed(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            replay(graph)
            end.record()
            events.append((graph, start, end))

        torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self.replay

    def seconds(self) -> list:
        """(graph, device seconds) of every replay."""
        torch.cuda.synchronize()
        return [(g, 1e-3 * s.elapsed_time(e)) for g, s, e in self.events]


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``calls`` calls, warmed
    on a side stream, replayed ``replays`` times between CUDA events; the
    least replay over the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best
