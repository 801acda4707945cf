"""Spans: named regions of the port's steps, seen by a torch profiler.

    from repro_torch import obs

    with obs.span("repro.step", timed=True):
        with obs.span("repro.model"):
            loss, grads = ...

While no torch profiler records, :func:`span` returns one shared no-op
context: it costs one read of ``torch.autograd.profiler``'s
``_is_profiler_enabled`` flag, and allocates, launches and synchronises
nothing. There is no setting: the spans are on exactly while a profiler
records.

While one records, a span

* opens a host event of its name (``_RecordFunctionFast``: kineto's
  ``cpu_op``, on the clock of the device trace, with no device-side
  track of its own, so it adds nothing to the card's busy time in a
  trace), and
* where it is timed, records a timing event on the current stream at
  entry and at exit. An outermost span is timed where it asks for it
  (``timed=True``: the training steps) and CUDA is initialised; a nested
  span is timed where its parent is. The serve round's spans are read
  from the trace's host events alone, so they, and B1's spans inside
  them, record no CUDA event and cost the round no CUDA call.

Spans nest. Each closed timed span is credited with its *self* device
time: its interval less its direct children's intervals, so the self
times of every span inside a step add up to the step's own interval (the
card's busy time in it and any idle time between its launches). A closed
outermost span is folded into per-name totals once ``Event.query()`` says
its last event has run; nothing on the span's path waits for the card,
the record stays bounded by how far the host runs ahead of the card, and
the events are reused.

:func:`spans` returns ``{name: (count, self_device_ms or None)}``
(None: no span of the name was timed) and waits for the card to finish
what is left, so call it after the profiled work.
:func:`reset` clears the totals.

To see the spans of a run::

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs

    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches[:3]:
            params, state, metrics = train_step(params, state, batch, key)
    for name, (count, ms) in sorted(obs.spans().items()):
        print(f"{name:22s} {count:6d} {ms} ms")
    prof.export_chrome_trace("trace.json")   # repro.* among the host ops

The spans of the port (``bench/metrics`` reads them by these names):

=====================  ==============================================
``repro.step``         both trainers' ``train_step``
``repro.model``        one machine's forward and ``autograd.grad``
``repro.wire.noise``   ``core.transport.wire_noise``
``repro.wire.corrupt`` ``core.transport.wire_corrupt``
``repro.b1.plan``      ``agg.kernel.ostat`` on the card: B1's host
                       wrapper (constants, library, launch plan)
``repro.b1.widen``     ``ostat`` on the card: the f32 copy in and the
                       cast back (``repro.b1`` nests in it); on the
                       small-m path, the output's allocation alone
``repro.b1``           the launch of kernel B1
``repro.tree``         ``core.protocol.protocol_tree_rounds``' rounds
``repro.lbfgs``        ``core.bfgs.two_loop_`` and ``lbfgs_gamma``
``repro.optim``        ``AdamW.update`` and ``apply_updates``
``repro.serve.submit`` ``AggregationService.submit_many``
``repro.serve.flush``  ``AggregationService.flush``
``repro.serve.sync``   the flush's wait for the card
``repro.ssm``          a Mamba2 layer of Zamba2 as published (its
                       norm, mixer and residual), forward, recompute
                       and backward
``repro.shared``       a shared-block insertion of Zamba2 as published
                       (the block, its adapter and ``linear``),
                       forward, recompute and backward
=====================  ==============================================

The spans nest on one stack: the port runs its steps on one thread. A
block's span in the backward pass (:func:`block_span`) opens and closes
on the autograd engine's thread while the step's thread waits inside
``autograd.grad``, so the stack stays one.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["span", "spans", "reset", "block_span"]

_NOOP = contextlib.nullcontext()


class _Node:
    """One closed (or open) span: its name, its entry and exit events
    (None where it is not timed) and its direct children."""
    __slots__ = ("name", "t0", "t1", "kids")

    def __init__(self, name: str, t0):
        self.name, self.t0, self.t1, self.kids = name, t0, None, []


_stack: list = []                                  # the open spans
_pending: collections.deque = collections.deque()  # closed outermost spans
_totals: Dict[str, list] = {}                      # name -> [count, ms]
_pool: list = []                                   # free timing events


def _event():
    try:
        ev = _pool.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("_rf", "_name", "_timed")

    def __init__(self, name: str, timed: bool):
        self._name, self._timed = name, timed
        self._rf = _RecordFunctionFast(name)

    def __enter__(self):
        self._rf.__enter__()
        if _stack:
            timed = _stack[-1].t0 is not None
        else:
            timed = self._timed and torch.cuda.is_initialized()
        _stack.append(_Node(self._name, _event() if timed else None))
        return self

    def __exit__(self, *exc):
        node = _stack.pop()
        if node.t0 is not None:
            node.t1 = _event()
        self._rf.__exit__(*exc)
        if _stack:
            _stack[-1].kids.append(node)
        else:
            _pending.append(node)
            _fold_pending(wait=False)
        return False


def span(name: str, *, timed: bool = False):
    """A context that marks a region ``name`` while a torch profiler
    records, and the shared no-op context otherwise. ``timed``: where the
    span is outermost, time it and every span inside it on the card."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, timed)


class _Hold:
    """The context of one block's span, shared by its two autograd
    nodes."""
    __slots__ = ("name", "cm")

    def __init__(self, name: str):
        self.name, self.cm = name, _NOOP


class _Enter(torch.autograd.Function):
    """The identity at a block's inputs: opens the span in the forward
    pass and closes it in the backward pass, after the block's backward
    (and its recompute) has run."""

    @staticmethod
    def forward(ctx, hold, *xs):
        ctx.hold = hold
        hold.cm = span(hold.name)
        hold.cm.__enter__()
        return xs

    @staticmethod
    def backward(ctx, *gs):
        ctx.hold.cm.__exit__(None, None, None)
        return (None,) + gs


class _Exit(torch.autograd.Function):
    """The identity at a block's outputs: closes the span in the forward
    pass and opens it again in the backward pass, before the block's
    backward."""

    @staticmethod
    def forward(ctx, hold, *ys):
        ctx.hold = hold
        hold.cm.__exit__(None, None, None)
        return ys

    @staticmethod
    def backward(ctx, *gs):
        hold = ctx.hold
        hold.cm = span(hold.name)
        hold.cm.__enter__()
        return (None,) + gs


class block_span:
    """A span over a block of the model in the forward pass, its
    recompute and its backward pass: ``xs = s.enter(*xs)`` on the
    block's inputs and ``ys = s.exit(*ys)`` on its outputs (each returns
    a tuple; a None passes through). The block runs between two identity
    nodes of the autograd graph, which the backward pass reaches after
    and before the block's own nodes, so a block rematerialised between
    them is credited with its recompute too. While no profiler records
    at construction, both are the identity and add no node."""
    __slots__ = ("_hold",)

    def __init__(self, name: str):
        self._hold = _Hold(name) if _profiler._is_profiler_enabled \
            else None

    def enter(self, *xs):
        return self._apply(_Enter, xs)

    def exit(self, *ys):
        return self._apply(_Exit, ys)

    def _apply(self, fn, xs):
        """``fn`` over the tensors of ``xs``; a None passes as it is."""
        if self._hold is None:
            return xs
        out = iter(fn.apply(self._hold, *[x for x in xs if x is not None]))
        return tuple(None if x is None else next(out) for x in xs)


def _fold(node: _Node) -> float:
    """Credit ``node`` and its children to the totals; returns its
    interval in ms (0 where it was not timed). Its events are done."""
    total = _totals.setdefault(node.name, [0, None])
    total[0] += 1
    kids_ms = sum(_fold(kid) for kid in node.kids)
    if node.t0 is None:
        return 0.0
    ms = node.t0.elapsed_time(node.t1)
    total[1] = (total[1] or 0.0) + ms - kids_ms
    _pool.extend((node.t0, node.t1))
    return ms


def _fold_pending(wait: bool) -> None:
    """Fold the closed outermost spans, oldest first: those whose last
    event has run, or, with ``wait``, every one after the card has run
    it."""
    while _pending:
        last = _pending[0].t1
        if last is not None:
            if wait:
                last.synchronize()
            elif not last.query():
                return
        _fold(_pending.popleft())


def spans() -> Dict[str, Tuple[int, Optional[float]]]:
    """``{name: (count, self_device_ms or None)}`` of every span closed
    since the last :func:`reset`; waits for the card to run what is
    left."""
    _fold_pending(wait=True)
    return {name: (count, ms) for name, (count, ms) in _totals.items()}


def reset() -> None:
    """Forget every closed span (spans still open are kept)."""
    _pending.clear()
    _totals.clear()
