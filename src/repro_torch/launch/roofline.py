"""Roofline terms of a dry-run cell on the H100 (the JAX package's
``launch/roofline.py``, there for TPU v5e).

Per (arch x shape x mesh) cell::

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = link bytes within one host / NVLINK_BW
               + link bytes between hosts / NETWORK_BW

All inputs are per-device quantities (:mod:`repro_torch.launch.costs`
counts rank 0's program).  ``PEAK_FLOPS`` is the bf16 dense tensor-core
rate for every flop: JAX counts int8 at the bf16 rate on v5e, and the
port keeps that convention (the card's int8 rate is twice it, so the
compute term of an int8 serving cell is an upper figure).  The
collective term splits link bytes by where the group lies: a group
inside one 8-card host rides NVLink, any other one a card's network
adapter (the rates and their sources live in
:mod:`repro_torch.benchmarks.common`).

``MODEL_FLOPS`` is the analytic useful-work floor:
    train   6·N_active·tokens      (fwd 2x + bwd 4x)
    prefill 2·N_active·tokens
    decode  2·N_active·batch       (one token per sequence)
The ratio MODEL_FLOPS / (counted flops x devices) exposes remat and
redundant work.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.benchmarks.common import (BF16_OPS_PER_S, HBM_BYTES_PER_S,
                                           NETWORK_BYTES_PER_S,
                                           NVLINK_BYTES_PER_S)

PEAK_FLOPS = BF16_OPS_PER_S       # dense bf16; int8 counted at this rate
HBM_BW = HBM_BYTES_PER_S
NVLINK_BW = NVLINK_BYTES_PER_S
NETWORK_BW = NETWORK_BYTES_PER_S


def roofline_terms(cost: dict, *, n_devices: int) -> Dict[str, float]:
    """JAX's keys from a cost dict (:class:`~repro_torch.launch.costs.
    CostCounter.result`); link bytes without the within-host share
    (``collective_link_bytes_host``) are taken as between hosts."""
    compute = cost["flops"] / PEAK_FLOPS
    memory = cost["bytes"] / HBM_BW
    host = cost.get("collective_link_bytes_host", 0.0)
    collective = (host / NVLINK_BW
                  + (cost["collective_link_bytes"] - host) / NETWORK_BW)
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant[0],
        "step_lower_bound_s": bound,
        # the share of the bound the compute term is: what the step
        # would reach at the dominant term with the others overlapped
        "roofline_fraction": (compute / bound) if bound > 0 else 0.0,
    }


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def count_params(tree, *, active_moe: Optional[float] = None,
                 moe_key: str = "moe") -> Dict[str, float]:
    """(total, active) element counts of a parameter tree (meta tensors
    do, or anything with a ``shape``).  ``active_moe`` scales the leaves
    under a ``moe`` subtree by top_k / n_experts, JAX's MoE convention."""
    total = 0.0
    active = 0.0
    for path, leaf in _paths(tree):
        n = 1.0
        for d in leaf.shape:
            n *= d
        total += n
        frac = active_moe if (active_moe is not None
                              and moe_key in path) else 1.0
        active += frac * n
    return {"total": total, "active": active}


def model_flops(kind: str, n_active: float, *, tokens: float) -> float:
    """Analytic useful flops of the whole step (all devices)."""
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens     # prefill and decode: forward only


__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NETWORK_BW",
           "roofline_terms", "count_params", "model_flops"]
