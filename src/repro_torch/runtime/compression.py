"""int8 gradient compression with error feedback and a checksum-verified
all-reduce (the JAX package's ``runtime/compression.py``): the paper's
quantized operator plus ABFT, applied to the data-parallel collective.

Scheme per leaf:
  1. residual-corrected gradient g' = g + e  (error feedback)
  2. per-leaf symmetric int8 quantization: q = round(g' / s),
     s = max|g'| / 127
  3. all-reduce the int8 payload in int32 and all-reduce the scales;
  4. verify: the mod-8191 value checksum of an integer sum equals the
     mod-sum of the per-replica checksums (additivity), so one extra
     scalar all-reduce per leaf detects a corrupted reduction;
  5. e <- g' - dequant(q)  (the local residual for the next step).

``group`` takes the place of JAX's ``axis_name``: ``None`` is the
single-device, verify-only path; a ``torch.distributed`` process group
all-reduces (SUM) the int32 payload, the scales and the residues over its
ranks.  The quotients divide by tensors, so the card takes the IEEE
quotient as JAX run op by op does (under ``jax.jit`` XLA folds ``/ 127``
into a multiply by the reciprocal, ROADMAP §C5).  Residues are floor
remainders (``torch.remainder``, JAX's ``%``), non-negative for negative
q.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

# 2^13-1 (Mersenne prime): residues < 8191 sum exactly in int32 across
# chunks of 262k elements and across 262k replicas
MOD = 8191


class CompressionState(NamedTuple):
    error: dict   # per-leaf f32 residuals (error-feedback memory)


def init_compression(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-30) / _const(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _mod_checksum(q_i32: torch.Tensor, mod: int = MOD) -> torch.Tensor:
    """Value checksum of an integer tensor, additive under summation: the
    residues' sum mod ``mod`` (int32).  Residues are summed in int32 over
    chunks small enough that no partial sum overflows (chunk * mod <
    2^31), as JAX sums them; every sum is exact, so the value is JAX's
    bit for bit."""
    r = torch.remainder(q_i32.reshape(-1).to(torch.int32), mod)
    chunk = (2 ** 31 - 1) // mod
    n_full = (r.numel() // chunk) * chunk
    head = torch.remainder(
        r[:n_full].reshape(-1, chunk).sum(dim=1, dtype=torch.int32), mod)
    tail = torch.remainder(r[n_full:].sum(dtype=torch.int32), mod)
    total = head.sum(dtype=torch.int64) + tail
    return torch.remainder(total, mod).to(torch.int32)


def compress_grads(grads, state: CompressionState):
    """-> (payload {q: int8, scale: f32, checksum: int32}, new state)."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                         state.error)
    qs = tree_map(_quantize_leaf, corrected)
    q = tree_map(lambda _c, t: t[0], corrected, qs)
    scale = tree_map(lambda _c, t: t[1], corrected, qs)
    new_error = tree_map(lambda c, qq, s: c - qq.to(torch.float32) * s,
                         corrected, q, scale)
    checksum = tree_map(_mod_checksum, q)
    payload = {"q": q, "scale": scale, "checksum": checksum}
    return payload, CompressionState(error=new_error)


def _count(flags) -> torch.Tensor:
    """The number of true 0-d flags, as an int32 0-d tensor."""
    flags = tree_leaves(flags)
    return torch.stack(flags).to(torch.int32).sum(dtype=torch.int32)


def verify_payload(payload: dict) -> torch.Tensor:
    """Recompute the checksums of a (possibly transported) payload;
    -> the number of leaves whose checksum mismatches."""
    return _count(tree_map(lambda e, q: e != _mod_checksum(q),
                           payload["checksum"], payload["q"]))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``psum`` over the ranks of ``group``: a new tensor (``x``
    itself for ``group=None``, the one-device degenerate case)."""
    if group is None:
        return x
    import torch.distributed as dist
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def checked_psum(payload: dict, group=None):
    """All-reduce the int8 payload with ABFT verification.

    Returns (summed q as an int32 tree, summed scales, error count as an
    int32 0-d tensor).  ``group=None`` is the single-device degenerate
    collective: the sum is the payload itself, and the additivity check
    still recomputes each leaf's checksum against the one encoded at
    compress time, so the mismatch branch is reachable without a
    process group."""
    q32 = tree_map(lambda q: q.to(torch.int32), payload["q"])
    summed = tree_map(lambda q: psum(q, group), q32)
    scale_sum = tree_map(lambda s: psum(s, group), payload["scale"])
    # additivity: checksum(psum(q)) == psum(checksum(q)) mod M
    expected = tree_map(
        lambda c: torch.remainder(psum(torch.remainder(c, MOD), group),
                                  MOD), payload["checksum"])
    errs = tree_map(lambda e, s: e != _mod_checksum(s), expected, summed)
    return summed, scale_sum, _count(errs)


def checked_psum_attributed(payload: dict, group=None):
    """:func:`checked_psum` plus this rank's receive-side
    :func:`verify_payload` count: (summed q, summed scales, the
    collective's error count, this rank's local count)."""
    local_errs = verify_payload(payload)
    summed, scale_sum, errs = checked_psum(payload, group)
    return summed, scale_sum, errs, local_errs


def decompress_grads(summed_q, scale_sum, n_replicas: int):
    """Mean gradient: (Σ_r q_r) * (Σ_r s_r / R) / R."""
    def dec(q, s):
        n = _const(float(n_replicas), s)
        return q.to(torch.float32) * (s / n) / n
    return tree_map(dec, summed_q, scale_sum)


def compressed_allreduce(grads, state: CompressionState,
                         group=None, n_replicas: int = 1):
    """compress -> checked all-reduce -> decompress; ``group=None`` with
    ``n_replicas=1`` is the single-device path.  -> (mean grads f32, new
    state, error count)."""
    payload, new_state = compress_grads(grads, state)
    summed, scale_sum, errs = checked_psum(payload, group)
    mean = decompress_grads(summed, scale_sum, n_replicas)
    return mean, new_state, errs


__all__ = ["MOD", "CompressionState", "init_compression", "compress_grads",
           "psum",
           "verify_payload", "checked_psum", "checked_psum_attributed",
           "decompress_grads", "compressed_allreduce"]
