"""Logical-axis -> mesh-axis rule sets (the JAX package's
``sharding/rules.py``, the same dicts).

Axes used by the model zoo:
  batch        activation batch dim
  seq          activation sequence dim (unsharded in baseline)
  kv_seq       decode KV-cache sequence dim (sequence-parallel decode)
  embed        d_model dim of weights (FSDP axis in training)
  mlp          FFN hidden dim (column-parallel)
  mlp_in       FFN hidden dim as a *contraction* dim (row-parallel)
  heads_x      merged q/k/v/o projection output dim
  vocab        vocabulary dim (embedding rows / lm-head cols)
  expert       MoE expert dim
  expert_mlp   per-expert FFN hidden dim
  table_rows   DLRM embedding-table rows
  conv / state small dims, never sharded
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

Rules = Dict[str, Union[str, Tuple[str, ...], None]]


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def train_rules(multi_pod: bool = False) -> Rules:
    """Training: FSDP over ``data`` for params + TP over ``model``."""
    return {
        "batch": batch_axes(multi_pod),
        "seq": None,
        "kv_seq": "model",
        "embed": "data",
        "mlp": "model",
        "mlp_in": "model",
        "heads_x": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "model",
        "table_rows": "model",
        "frontend": None,
    }


def serve_rules(multi_pod: bool = False) -> Rules:
    """Serving: pure TP (weights static, no FSDP gathers), batch over
    ``data``, the KV cache sequence-parallel over ``model``."""
    r = train_rules(multi_pod)
    r["embed"] = None        # replicate weight d_model dim across `data`
    return r


__all__ = ["Rules", "batch_axes", "train_rules", "serve_rules"]
