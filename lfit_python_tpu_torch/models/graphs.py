"""Posterior calls replayed from CUDA graphs.

A posterior evaluation on the card is a few hundred small kernels (a
gradient evaluation a few thousand), and the host takes longer to enqueue
them one by one than the card takes to run them.  :class:`GraphCache`
captures a call once per (entry, input shape, dtype, device) as a
``torch.cuda.CUDAGraph`` and replays it after that: the kernels the eager
call launches, in its order, with its arguments, so that a replay gives
the eager call's bits.  A gradient entry (``value_and_grad``) is captured
whole: the forward, autograd's backward pass and what follows it.

The route depends only on what a call can observe (:func:`routable`, and
whether its key was seen before):

- a call on the CPU, one that autograd records (grad mode on) and one made
  while a graph is being captured run eagerly (a gradient entry turns
  grad mode off around its call and autograd on inside it, so that it
  takes the route in any grad mode of its caller);
- the first call with a key runs eagerly;
- the second runs once on a side stream (the warm-up, whose result it
  returns) and is then captured with a static input buffer, the recipe of
  the ``torch.cuda.graphs`` documentation;
- every later call copies its input into that buffer, replays the graph
  and returns clones of its static outputs, which the next replay
  overwrites;
- once :data:`MAX_GRAPHS` keys are captured, new keys run eagerly, so
  that calls of ever new shapes (the start ball's re-draws) never fill
  the card with graph pools.

A replay enters none of the posterior's stage spans: it is one
``lfit.replay`` span (``utils/tracing.py``).  The kernel wrappers' launch
counters (:func:`..ops.launch_counts`) count a replay's launches: a
replay adds what its capture counted, and the capture, which runs
nothing, leaves them as they were.
"""

from __future__ import annotations

import torch

from ..ops import add_launch_counts, launch_counts
from ..utils.tracing import REPLAY, annotate

__all__ = ["MAX_GRAPHS", "Replay", "capture", "routable", "GraphCache"]

# the most graphs one cache captures
MAX_GRAPHS = 4


def _each(out, fn):
    """``fn`` of the output tensor, or of each of a tuple of them."""
    return tuple(fn(t) for t in out) if isinstance(out, tuple) else fn(out)


class Replay:
    """One captured call: calling it with an input of the captured shape,
    dtype and device gives the call's result."""

    def __init__(self, graph, static_in, static_out, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches   # each launch counter's increase

    def __call__(self, var):
        with annotate(REPLAY):
            self.static_in.copy_(var)
            self.graph.replay()
            add_launch_counts(self.launches)
            return _each(self.static_out, torch.clone)


def capture(fn, var):
    """(the :class:`Replay` of ``fn`` at ``var``'s shape, dtype and
    device, ``fn(var)``).  ``fn`` runs once on a side stream, which gives
    the result, and is then captured, which runs nothing."""
    with torch.cuda.device(var.device):
        stream = torch.cuda.current_stream()
        static_in = var.clone()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = fn(static_in)
        stream.wait_stream(side)
        _each(out, lambda t: t.record_stream(stream))
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(static_in)
        launches = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launch_counts(tuple(-n for n in launches))
    return Replay(graph, static_in, static_out, launches), out


def _on_card(var):
    """True for a tensor on a card, with no capture under way."""
    return var.is_cuda and not torch.cuda.is_current_stream_capturing()


def routable(var):
    """True where a call on ``var`` may be replayed: on a card, with no
    capture under way, and grad mode off (autograd records nothing)."""
    return not torch.is_grad_enabled() and _on_card(var)


class GraphCache:
    """One posterior's calls, eager or replayed (module docstring).
    ``capture(fn, var) -> (replay, fn(var))`` makes a graph."""

    def __init__(self, capture=capture):
        self.capture = capture
        self.seen = set()
        self.graphs = {}

    def __call__(self, entry, fn, var):
        """``fn(var)`` of the entry named ``entry``."""
        if not routable(var):
            return fn(var)
        key = (entry, tuple(var.shape), var.dtype, var.device)
        replay = self.graphs.get(key)
        if replay is not None:
            return replay(var)
        if key not in self.seen or len(self.graphs) >= MAX_GRAPHS:
            self.seen.add(key)
            return fn(var)
        self.graphs[key], out = self.capture(fn, var)
        return out
