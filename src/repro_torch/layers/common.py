"""Shared layer context."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call layer context.

    ``quant=True`` selects the paper's int8 pipeline (Fig. 1) with ABFT.
    Protection is governed by ``plan`` (a
    :class:`repro_torch.protect.ProtectionPlan`); when ``plan`` is None the
    legacy booleans apply: ``abft`` gates int8 GEMM + EB verification and
    ``float_abft`` gates float-GEMM ABFT.  ``wkv_chunk > 0`` selects the
    chunked matmul form of the RWKV6 WKV recurrence (kernel K4 on the
    card) over a prefill's whole chunks.  The JAX context's
    sharding, scan and cost-probe fields and its bf16 WKV operands
    (``wkv_mm_bf16``) belong to slices not ported yet.
    """
    quant: bool = False                   # int8 serving path
    abft: bool = True                     # ABFT verification on (legacy)
    float_abft: bool = False              # float ABFT on GEMMs (legacy)
    plan: Optional[Any] = None            # ProtectionPlan (overrides flags)
    compute_dtype: Any = torch.bfloat16
    wkv_chunk: int = 0                    # >0: chunked matmul-form WKV6

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
