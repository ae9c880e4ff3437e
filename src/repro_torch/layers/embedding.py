"""Quantized EmbeddingBag + ABFT (the DLRM serving path).

Verification routes through :func:`repro_torch.protect.protected_call`
(op kind ``embedding_bag``) so the plan controls on/off, policy and the
Eq. (5) ``rel_bound``.  A DLRM's tables are one stacked parameter
(``[tables, rows, d]``), served by one kernel launch with one check per
table.  The bf16 token embedding of the JAX package belongs to the LM
slice (ROADMAP A8).
"""
from __future__ import annotations

import torch

from repro_torch.core import table_rowsums
from repro_torch.layers.common import Ctx
from repro_torch.protect.runtime import protected_call


def init_qembed(gen: torch.Generator, vocab: int, d: int, device="cpu"):
    """Quantized table in [-127, 127], alphas ~ U(5e-3, 2e-2), betas ~
    U(-0.1, 0.1), with precomputed int32 row sums."""
    table = torch.randint(-127, 128, (vocab, d), dtype=torch.int8,
                          generator=gen, device=device)
    alphas = torch.empty((vocab,), dtype=torch.float32, device=device)
    alphas.uniform_(5e-3, 2e-2, generator=gen)
    betas = torch.empty((vocab,), dtype=torch.float32, device=device)
    betas.uniform_(-0.1, 0.1, generator=gen)
    return {"table": table, "alphas": alphas, "betas": betas,
            "rowsums": table_rowsums(table)}


def init_embedding_bag(gen: torch.Generator, n_tables: int, rows: int,
                       d: int, device="cpu"):
    """DLRM multi-hot tables, stacked ``[n_tables, rows, d]``.

    Tables are drawn one at a time (:func:`init_qembed`) into their slice
    of the stack: at full width (26 x 4M x 128) the tables are 13.3 GB,
    and an int32 copy of all of them for the row sums would be 53 GB.
    """
    out = {"table": torch.empty((n_tables, rows, d), dtype=torch.int8,
                                device=device)}
    for k, dtype in (("alphas", torch.float32), ("betas", torch.float32),
                     ("rowsums", torch.int32)):
        out[k] = torch.empty((n_tables, rows), dtype=dtype, device=device)
    for t in range(n_tables):
        for k, v in init_qembed(gen, rows, d, device).items():
            out[k][t] = v
    return out


def embedding_bag_fwd(p, indices: torch.Tensor, ctx: Ctx, weights=None,
                      name: str = "tables"):
    """indices [bags, pool] (or [tables, bags, pool] for a stack; −1
    padded) -> ([..., bags, d] in the compute dtype, report)."""
    enc = (p["table"], p["alphas"], p["betas"], p["rowsums"])
    r, report = protected_call("embedding_bag", enc, indices, weights,
                               ctx=ctx, name=name)
    return r.to(ctx.compute_dtype), report
