"""Shared layer context, and the helpers over stacked-layer trees."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call layer context.

    ``quant=True`` selects the paper's int8 pipeline (Fig. 1) with ABFT;
    False is the float training path.  Protection is governed by ``plan``
    (a :class:`repro_torch.protect.ProtectionPlan`); when ``plan`` is
    None the legacy booleans apply: ``abft`` gates int8 GEMM + EB
    verification and ``float_abft`` gates float-GEMM ABFT.
    ``wkv_chunk > 0`` selects the chunked matmul form of the RWKV6 WKV
    recurrence: in the int8 serving prefill over the whole chunks (kernel
    K4 on the card), in the float form when the length divides (plain
    PyTorch under autograd, with bf16 matmul operands and float32
    accumulation where ``wkv_mm_bf16``).  ``ssm_chunk > 0`` runs the
    Mamba scan in chunks, each recomputed in the backward (JAX's
    two-level remat: the same steps, less memory).  ``moe_gather``
    selects the MoE's scatter / gather dispatch (False: the one-hot
    einsums) and ``moe_seq_groups`` runs its token groups one at a time
    (:mod:`repro_torch.layers.moe`).  ``scan_graphs`` (a
    :class:`repro_torch.layers.scan.ScanGraphs`, which
    :func:`repro_torch.launch.steps.make_train_step` makes for its step)
    replays the training scans' token loops from CUDA graphs on the
    card; None runs them eagerly.  It is the step's cache, not a
    setting: equality and hashing ignore it.

    ``rules`` (JAX's) are the sharding rules :func:`repro_torch.sharding.
    constrain` reads at the layers' constraint sites: on one device and
    on a data mesh a constraint moves nothing, on the dry run's meta
    ``DTensor`` s it redistributes.  ``no_remat`` (JAX's) keeps every
    layer's activations in training; by default the LM families
    recompute each layer in the backward (``torch.utils.checkpoint``), as
    JAX remats its layer scan.  JAX's ``unroll_layers`` and
    ``unroll_time`` have no counterpart: XLA's ``cost_analysis`` counts a
    ``while`` body once, so JAX's probes unrolled their scans, while the
    port's layer and time loops are Python loops whose every trip the
    cost counter (:mod:`repro_torch.launch.costs`) sees.
    ``abft_tp_local`` is JAX's flag for per-shard checksums under tensor
    parallelism; as in JAX, nothing reads it.  ``data_group`` (the data
    mesh step's, :func:`repro_torch.launch.steps.make_train_step`) is the
    process group over whose ranks a replicated step splits the batch:
    the MoE's load-balance statistics are all-reduced over it, so each
    rank's loss holds the global batch's (ROADMAP §C17).  Like
    ``scan_graphs`` it is the step's, not a setting.
    """
    rules: Optional[dict] = dataclasses.field(default=None, hash=False)
    quant: bool = False                   # int8 serving path
    abft: bool = True                     # ABFT verification on (legacy)
    float_abft: bool = False              # float ABFT on GEMMs (legacy)
    plan: Optional[Any] = None            # ProtectionPlan (overrides flags)
    compute_dtype: Any = torch.bfloat16
    wkv_chunk: int = 0                    # >0: chunked matmul-form WKV6
    wkv_mm_bf16: bool = False             # bf16 WKV matmul operands (f32 acc)
    ssm_chunk: int = 0                    # >0: chunked, rematted mamba scan
    moe_gather: bool = False              # scatter/gather MoE dispatch
    no_remat: bool = False                # keep every layer's activations
    moe_seq_groups: bool = False          # MoE token groups one at a time
    abft_tp_local: bool = False           # per-shard checksums (JAX's flag)
    data_group: Optional[Any] = dataclasses.field(default=None,
                                                  compare=False)
    scan_graphs: Optional[Any] = dataclasses.field(default=None,
                                                   compare=False)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def stack_layers(trees):
    """Per-layer trees -> one tree with a leading layer axis ``[L, ...]``
    (dicts and named tuples rebuilt, tensors stacked), the layout the JAX
    package's layer scan gives."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_layers(list(f)) for f in zip(*trees)))
    return torch.stack(trees)


def init_stacked(make, n: int):
    """``stack_layers([make() for _ in range(n)])`` without holding the
    ``n`` layers and their stack at once: each layer made is written into
    preallocated ``[n, ...]`` leaves and dropped, so the peak is the stack
    and one layer.  ``make`` runs ``n`` times in order, as in the list,
    so a generator it draws from gives the same tensors."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(alloc(v) for v in t))
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(out, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(out[k], v, i)
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for o, v in zip(out, t):
                put(o, v, i)
        else:
            out[i].copy_(t)

    out = None
    for i in range(n):
        layer = make()
        if out is None:
            out = alloc(layer)
        put(out, layer, i)
        del layer
    return out


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree: one ``torch.unbind``
    per leaf.  Its backward stacks the layers' gradients in one op, where
    ``n`` calls of :func:`layer_at` (one select each) would each write a
    zero-filled gradient of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [unstack_layers(v, n) for v in tree]
        return [type(tree)(*(p[i] for p in parts)) for i in range(n)]
    return list(torch.unbind(tree, 0))


def layer_at(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_at(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(layer_at(v, i) for v in tree))
    return tree[i]
