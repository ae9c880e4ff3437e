"""Weights from the JAX package into the port, through numpy.

The caller strips the JAX tree to plain arrays first (``LogicalParam``
values, then ``np.asarray``), so this module imports nothing of JAX.  The
packed layouts are shared, so the arrays move unchanged:

* DLRM: ``bottom`` / ``top`` lists of ``{w_packed, alpha, colsum, b}``
  and ``tables`` ``{table, alphas, betas, rowsums}`` with a leading table
  axis (the JAX model vmaps its table init);
* RWKV6 (``init_rwkv(..., quant=True)``): ``embed`` ``{table, alphas,
  betas, rowsums}``, ``ln0``/``ln_out`` ``{scale, bias}``, ``head``
  ``{w_packed, alpha, colsum}`` and ``layers`` with every leaf stacked on
  a leading ``[L, ...]`` axis (``ln1``, ``tm``, ``ln2``, ``cm``), which
  :mod:`repro_torch.models.rwkv` indexes as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax(tree: Any, device="cuda") -> Any:
    """A tree of numpy arrays -> the same tree of torch tensors on
    ``device`` (dicts, lists and tuples are rebuilt, dtypes kept)."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if isinstance(node, np.ndarray) or np.isscalar(node):
            # a copy: the tensor never aliases the caller's array
            return torch.from_numpy(np.array(node)).to(dev)
        raise TypeError(f"from_jax expects numpy arrays, got "
                        f"{type(node).__name__}")

    return rec(tree)
