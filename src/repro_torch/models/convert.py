"""Weights from the JAX package into the port, through numpy.

The caller strips the JAX tree to plain arrays first (``LogicalParam``
values, then ``np.asarray``), so this module imports nothing of JAX.  The
packed layouts are shared, so the arrays move unchanged; a bfloat16 array
(numpy holds it as the ``ml_dtypes`` type JAX hands over) moves by its
bits into ``torch.bfloat16``:

* DLRM: ``bottom`` / ``top`` lists of ``{w_packed, alpha, colsum, b}``
  (int8) or ``{w, b}`` (``init_dlrm(..., quant=False)``: the float
  linears), and ``tables`` ``{table, alphas, betas, rowsums}`` with a
  leading table axis (the JAX model vmaps its table init);
* the dense LM (``init_lm``): ``embed``, ``final_norm`` ``{scale}``,
  ``lm_head`` and ``layers`` (``ln1``, ``ln2``, ``attn``, ``mlp``) with
  every leaf stacked on a leading ``[L, ...]`` axis, which
  :mod:`repro_torch.models.lm` indexes as it is;
* RWKV6 (``init_rwkv``): ``embed`` ``{table, alphas, betas, rowsums}``
  (int8) or ``{table}`` (float), ``ln0``/``ln_out`` ``{scale, bias}``,
  ``head`` ``{w_packed, alpha, colsum}`` or ``{w}`` and ``layers`` with
  every leaf stacked on a leading ``[L, ...]`` axis (``ln1``, ``tm``
  with ``mu``, ``w0``, the decay LoRA and ``bonus``, ``ln2``, ``cm``),
  which :mod:`repro_torch.models.rwkv` indexes as it is;
* the MoE LM (granite): the dense LM's tree with ``moe`` {``router``,
  ``gate``, ``up``, ``down``} in place of ``mlp``, the experts stacked
  ``[L, E, k, n]`` (float ``w``) or packed ``[L, E, k, n + 128]``;
* the hybrid LM (hymba): the dense LM's tree, each layer with ``ssm``
  (``in_proj``, ``x_proj``, ``out_proj`` linears, ``conv_w``,
  ``dt_proj {w, b}``, ``a_log``, ``d_skip``), ``attn_out_norm`` and
  ``ssm_out_norm``, and the top-level ``meta`` tokens; the VLM (llava):
  the dense LM's tree and ``projector {fc1, fc2}`` (linears with bias);
* whisper (``init_whisper``): ``enc {layers {ln1, attn, ln2, mlp},
  ln_post}`` and ``dec {embed, pos, layers {ln1, self, ln2, cross, ln3,
  mlp}, ln, head}``, the LayerNorms ``{scale, bias}``, every linear with
  bias but the head, each stack of layers on a leading ``[L, ...]``
  axis;
* the float form of each (``quant=False``): ``{w}`` linears and the
  float token table ``{table}``, stacked as above;
* the whole training state (``launch.steps.init_train_state``):
  ``params``, ``opt`` ``{m, v, count}``, ``step`` and ``comm``, whose
  ``CompressionState`` becomes the port's
  (:class:`repro_torch.runtime.compression.CompressionState`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax(tree: Any, device="cuda") -> Any:
    """A tree of numpy arrays -> the same tree of torch tensors on
    ``device`` (dicts, lists, tuples and named tuples such as a QuantKV
    cache are rebuilt, dtypes kept)."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return _named_tuple(node)(*(rec(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if isinstance(node, np.ndarray) or np.isscalar(node):
            # a copy: the tensor never aliases the caller's array
            arr = np.array(node)
            if arr.dtype.name == "bfloat16":
                return torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16).to(dev)
            return torch.from_numpy(arr).to(dev)
        raise TypeError(f"from_jax expects numpy arrays, got "
                        f"{type(node).__name__}")

    return rec(tree)


def _named_tuple(node) -> type:
    """The port's class for a JAX named tuple of the training state (the
    compression residuals), else the tuple's own class."""
    if type(node).__name__ == "CompressionState":
        from repro_torch.runtime.compression import CompressionState
        return CompressionState
    return type(node)


def to_device(tree: Any, device) -> Any:
    """A tree of torch tensors (dicts, lists, tuples, named tuples) with
    every tensor copied to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
