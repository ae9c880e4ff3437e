"""The first-order linear recurrence both training scans run:

    h_t = a_t ∘ h_{t-1} + b_t,      t = 1 … S

(RWKV6's WKV state: ``a`` the decay, ``b = k ⊗ v``; the Mamba state:
``a = exp(Δ A)``, ``b = Δ B x``).  Every factor that does not read the
state is made before the loop, so a token is one multiply and one add
(JAX's step's two operations, in its order: the same values).  The
backward is written out as the reverse recurrence

    g_t = ∂L/∂h_t (from the outputs) + a_{t+1} ∘ g_{t+1}
    ∂L/∂b_t = g_t,   ∂L/∂a_t = g_t ∘ h_{t-1},   ∂L/∂h_0 = a_1 ∘ g_1

so a token costs two launches forward and two backward and no autograd
node.  A training step bound by the host (the loop runs for every layer
of every microbatch, one operation at a time) hands the scan a
:class:`ScanGraphs`, its own cache: under autograd on the card each
token loop is then replayed from a CUDA graph captured once per shape
(the same kernels on the same operands, so the same values as the loop
run eagerly), and the graphs' memory goes with the step.  Without a
cache, or without autograd (serving, decode), the loop runs eagerly.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch


def _forward_loop(a, b, h0):
    h, hs = h0, []
    for a_t, b_t in zip(torch.unbind(a, 1), torch.unbind(b, 1)):
        h = a_t * h + b_t
        hs.append(h)
    return torch.stack(hs, dim=1)


def _backward_loop(a, g_out):
    a_s, gs, g = torch.unbind(a, 1), [], None
    for t in range(g_out.shape[1] - 1, -1, -1):
        g = g_out[:, t] if g is None else g_out[:, t] + a_s[t + 1] * g
        gs.append(g)
    return torch.stack(gs[::-1], dim=1)


class ScanGraphs:
    """The token loops one owner (a training step) has captured, by loop,
    shapes, dtypes and device; the newest two are held (a step's forward
    and backward loop), each with its own copies of its inputs and
    output.  Dropping the cache frees them."""

    KEEP = 2

    def __init__(self):
        self._graphs: "OrderedDict" = OrderedDict()

    def replay(self, loop, *args):
        """``loop(*args)`` replayed from its CUDA graph at these shapes
        (captured on the first call: a warm-up on a side stream, then
        the capture), its inputs copied into the graph's own and its
        output copied out."""
        key = (loop.__name__,) + tuple((tuple(t.shape), t.dtype, t.device)
                                       for t in args)
        entry = self._graphs.get(key)
        if entry is None:
            static = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in args]
            for s, t in zip(static, args):
                s.copy_(t)
            dev = args[0].device
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                loop(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # another thread's device work (a checkpoint's) may run
            # meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = loop(*static)
            entry = (graph, static, out)
            self._graphs[key] = entry
            while len(self._graphs) > self.KEEP:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        graph, static, out = entry
        for s, t in zip(static, args):
            s.copy_(t)
        graph.replay()
        return out.clone()


class _LinearScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, h0, graphs):
        if not (a.is_cuda and any(ctx.needs_input_grad[:3])):
            graphs = None
        out = (_forward_loop(a, b, h0) if graphs is None
               else graphs.replay(_forward_loop, a, b, h0))
        ctx.save_for_backward(a, h0, out)
        ctx.b_shape = b.shape
        ctx.graphs = graphs
        return out

    @staticmethod
    def backward(ctx, g_out):
        a, h0, out = ctx.saved_tensors
        g_all = (_backward_loop(a, g_out) if ctx.graphs is None
                 else ctx.graphs.replay(_backward_loop, a, g_out))
        h_prev = torch.cat([h0[:, None], out[:, :-1]], dim=1)
        g_a = (g_all * h_prev).sum_to_size(a.shape)
        g_h0 = (a[:, 0] * g_all[:, 0]).sum_to_size(h0.shape)
        return g_a, g_all.sum_to_size(ctx.b_shape), g_h0, None


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                graphs: Optional[ScanGraphs] = None) -> torch.Tensor:
    """Every state ``h_1 … h_S`` of ``h_t = a_t ∘ h_{t-1} + b_t`` from
    ``h0``: -> ``[B, S, ...]``.  ``a`` and ``b`` are ``[B, S, ...]``
    (``a`` may broadcast over trailing axes: RWKV's decay over v), ``h0``
    ``[B, ...]``; differentiable in all three.  ``graphs``: the caller's
    cache of captured loops, replayed under autograd on the card (None:
    the loops run eagerly)."""
    return _LinearScan.apply(a, b, h0, graphs)
