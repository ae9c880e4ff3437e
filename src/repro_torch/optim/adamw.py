"""AdamW and gradient clipping as plain functions over tensor trees (the
JAX package's ``optim/adamw.py``, no ``torch.optim``).

The update is the JAX formula op for op: ``p - lr * (m̂ / (√v̂ + eps) +
wd * p)`` with the bias corrections ``1 - b**count`` taken in float32.
``torch.optim.AdamW`` decays the weights before the step and so rounds
differently.  Every division divides by a tensor: on the card PyTorch
turns a division by a Python scalar into a multiply by its reciprocal,
which is not the IEEE quotient JAX takes.

The square root is the IEEE one, as XLA's: on the card ``torch.sqrt``
is; on the CPU PyTorch's vectorized float32 ``sqrt`` is not correctly
rounded (1 ulp off in about 0.7% of values), so there it is taken in
float64 and rounded once, which is.

Moments are float32 whatever the parameter dtype.  Integer leaves (the
ABFT serving weights, EmbeddingBag tables, row sums) are frozen: they
get zero-size moments and pass through the update untouched.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def is_trainable(x: torch.Tensor) -> bool:
    """True for the leaves AdamW updates: floating dtypes."""
    return x.dtype.is_floating_point


def adamw_init(params):
    def mom(p):
        # zeros_like: a sharded parameter's moments are sharded alike
        if is_trainable(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros((0,), dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(mom, params), "v": tree_map(mom, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (module docstring)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def adamw_update(grads, opt_state, params, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """-> (new params, new opt state); nothing is updated in place, so the
    caller's state stays valid (the train loop's recompute re-runs a step
    from it)."""
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, cf), cf)
    bc2 = 1.0 - torch.pow(_f32(b2, cf), cf)

    def upd(g, m, v, p):
        if not is_trainable(p):
            return p, m, v
        gf = g.to(torch.float32)
        m_new = b1 * m + (1.0 - b1) * gf
        v_new = b2 * v + (1.0 - b2) * gf * gf
        mh = m_new / bc1
        vh = v_new / bc2
        step = mh / (ieee_sqrt(vh) + eps) \
            + weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * step).to(p.dtype)
        return p_new, m_new, v_new

    out = tree_map(lambda g, m, v, p: upd(g, m, v, p), grads,
                   opt_state["m"], opt_state["v"], params)
    pick = lambda i: tree_map(lambda _p, o: o[i], params, out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over trainable leaves of Σ x²), the leaf sums added in the
    flatten order as JAX adds them."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree) if is_trainable(x)]
    return ieee_sqrt(sum(leaves[1:], leaves[0]))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / ‖g‖), ‖g‖)."""
    gn = global_norm(grads)
    scale = torch.clamp(
        torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-9), max=1.0)

    def clip(g):
        if not is_trainable(g):
            return g
        return (g.to(torch.float32) * scale).to(g.dtype)
    return tree_map(clip, grads), gn
