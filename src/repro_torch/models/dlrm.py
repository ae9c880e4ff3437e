"""DLRM — the paper's own architecture (bottom MLP + EmbeddingBags +
pairwise interaction + top MLP), int8-quantized with ABFT end to end.

Every MLP GEMM runs Algorithm 1 (kernels K3 + K1 on the card), and all
tables run Algorithm 2 in one launch of kernel K2.  The dtype steps are
the JAX model's: the dense input is cast to the compute dtype, ReLU runs
in float32 and casts back, and the interaction runs in float32 before the
cast to the compute dtype.  The JAX model vmaps over tables; here the
table dimension is written out, and the report still counts one
``embedding_bag`` check per table.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.dlrm import DlrmExtras
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers.common import Ctx
from repro_torch.layers.embedding import (embedding_bag_fwd,
                                          init_embedding_bag)
from repro_torch.layers.linear import apply_linear, init_qlinear


def _init_mlp_stack(gen, dims, device):
    return [init_qlinear(gen, dims[i], dims[i + 1], device=device)
            for i in range(len(dims) - 1)]


@torch.no_grad()
def init_dlrm(seed: int, ex: DlrmExtras, *, table_rows: int | None = None,
              device="cuda"):
    """Random int8 DLRM parameters from ``seed``, made on ``device``.

    Same distributions as the JAX ``init_dlrm`` (int8 weights and tables
    in [-127, 127], alpha ~ U(1e-3, 2e-3), table alphas ~ U(5e-3, 2e-2),
    betas ~ U(-0.1, 0.1)), not the same values.  ``tables`` holds the
    stacked ``[n_tables, rows, emb_dim]`` layout of the JAX tree."""
    dev = resolve_device(device)
    rows = table_rows or ex.table_rows
    gen = torch.Generator(device=dev).manual_seed(seed)
    bottom = _init_mlp_stack(gen, (ex.n_dense,) + ex.bottom_mlp, dev)
    n_feat = ex.n_tables + 1
    inter_dim = ex.emb_dim + n_feat * (n_feat - 1) // 2
    top = _init_mlp_stack(gen, (inter_dim,) + ex.top_mlp, dev)
    tables = init_embedding_bag(gen, ex.n_tables, rows, ex.emb_dim,
                                device=dev)
    return {"bottom": bottom, "top": top, "tables": tables}


def _mlp_stack(layers, x, ctx, final_relu=False, name="mlp"):
    rep = policy.empty_report()
    for i, p in enumerate(layers):
        x, r = apply_linear(p, x, ctx, name=f"{name}.{i}")
        rep = policy.merge_reports(rep, r)
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x.to(torch.float32)).to(x.dtype)
    return x, rep


@torch.no_grad()
def dlrm_forward(params, dense: torch.Tensor, indices: torch.Tensor,
                 ctx: Ctx, ex: DlrmExtras
                 ) -> Tuple[torch.Tensor, policy.FaultReport]:
    """dense [B, n_dense] f32; indices [n_tables, B, pool] int32 (−1 pad).

    Returns (logit [B], report).  The [B, F, F] Gram product is a plain
    ``torch.bmm`` (the JAX model leaves it to XLA, outside any kernel);
    it matches the float32 reference only with TF32 off, which is
    PyTorch's default and what the serving engine sets."""
    bot, r1 = _mlp_stack(params["bottom"], dense.to(ctx.compute_dtype),
                         ctx, final_relu=True, name="bottom")  # [B, emb]
    embs, table_rep = embedding_bag_fwd(params["tables"], indices, ctx)

    feats = torch.cat([bot[None].to(torch.float32),
                       embs.to(torch.float32)], dim=0)         # [F,B,e]
    f = feats.transpose(0, 1)                                  # [B,F,e]
    gram = torch.bmm(f, f.transpose(1, 2))                     # [B,F,F]
    n_feat = f.shape[1]
    iu = torch.triu_indices(n_feat, n_feat, offset=1, device=f.device)
    inter = gram[:, iu[0], iu[1]]                              # [B,F(F-1)/2]
    z = torch.cat([bot.to(torch.float32), inter], dim=-1)
    logit, r2 = _mlp_stack(params["top"], z.to(ctx.compute_dtype), ctx,
                           name="top")
    return logit[:, 0], policy.merge_reports(r1, table_rep, r2)
