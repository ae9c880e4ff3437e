"""Quantized EmbeddingBag + ABFT: DLRM tables and LM token embeddings.

A token lookup is an EmbeddingBag with pooling size 1 (paper §III-C), so
the int8 token embedding runs the same kernel and the same Eq. (5) check
as a DLRM table.  Verification routes through
:func:`repro_torch.protect.protected_call` (op kind ``embedding_bag``) so
the plan controls on/off, policy and the Eq. (5) ``rel_bound``.  A DLRM's
tables are one stacked parameter (``[tables, rows, d]``), served by one
kernel launch with one check per table.  The float token embedding
(:func:`init_embed`, :func:`embed`) is a plain gather, unprotected, as in
the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core import policy, table_rowsums
from repro_torch.layers.common import Ctx
from repro_torch.protect.runtime import protected_call
from repro_torch.sharding.gspmd import is_dtensor, vocab_lookup


def init_embed(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device):
    """Float table ~ N(0, 1) * 0.02 — the JAX ``param()`` default
    (its distribution, not its values: the generators differ)."""
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return {"table": (w * 0.02).to(dtype)}


def embed(p, tokens: torch.Tensor, ctx: Ctx):
    """tokens [...] -> ([..., d] in the compute dtype, empty report).  A
    ``DTensor`` table (a mesh's) is looked up by
    :func:`repro_torch.sharding.gspmd.vocab_lookup`, each rank in its
    own rows of the vocabulary."""
    table = p["table"]
    if is_dtensor(table):
        return vocab_lookup(table, tokens).to(ctx.compute_dtype), \
            policy.empty_report()
    return table[tokens.long()].to(ctx.compute_dtype), policy.empty_report()


def init_qembed(gen: torch.Generator, vocab: int, d: int, *, device):
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
                       d: int, *, device):
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
        for k, v in init_qembed(gen, rows, d, device=device).items():
            out[k][t] = v
    return out


def qembed(p, tokens: torch.Tensor, ctx: Ctx, name: str = "embed"):
    """tokens [...] int -> ([..., d] in the compute dtype, report): one
    pool-1 bag per token through the protected EmbeddingBag."""
    shape = tokens.shape
    bags = tokens.reshape(-1, 1)
    enc = (p["table"], p["alphas"], p["betas"], p["rowsums"])
    r, report = protected_call("embedding_bag", enc, bags, ctx=ctx,
                               name=name)
    d = p["table"].shape[-1]
    return r.to(ctx.compute_dtype).reshape(*shape, d), report


def apply_embed(p, tokens: torch.Tensor, ctx: Ctx):
    """Dispatch on parameter form: the quantized table or the float one."""
    if "alphas" in p:
        return qembed(p, tokens, ctx)
    return embed(p, tokens, ctx)


def embedding_bag_fwd(p, indices: torch.Tensor, ctx: Ctx, weights=None,
                      name: str = "tables"):
    """indices [bags, pool] (or [tables, bags, pool] for a stack; −1
    padded) -> ([..., bags, d] in the compute dtype, report)."""
    enc = (p["table"], p["alphas"], p["betas"], p["rowsums"])
    r, report = protected_call("embedding_bag", enc, indices, weights,
                               ctx=ctx, name=name)
    return r.to(ctx.compute_dtype), report
