"""GShard-style Mixture of Experts (top-k gating, capacity factor) — the
JAX package's ``layers/moe.py``.

Tokens are routed within groups of ``group_size``: each token picks its
``top_k`` experts, each expert takes at most ``capacity`` tokens of a
group, and a token's choice past an expert's capacity is dropped.  The
router and the dispatch / combine data movement stay in floating point:
they are index logic, which ABFT does not cover (the same caveat as the
EmbeddingBag's indices).

In quant mode the per-expert FFN GEMMs run the paper's int8 ABFT
pipeline.  JAX vmaps ``quantize_rows`` and a protected qgemm over the
experts; here the quantizer is row-wise, so ONE call over the flattened
``[E·C', d]`` rows gives every expert's codes (one K3 launch on the
card), and the experts' GEMMs are ONE protected call over the stacked
packed weights ``[E, k, n + 128]`` whose error count is a vector over
experts (:meth:`repro_torch.protect.ops.QGemmOp.__call__`; one K1 launch
an expert on the card, each against its own B′).  The report then sums
to what JAX's vmap sums, and ``recompute`` reads one count vector a
projection.  Every expert runs over its whole capacity, as the vmap
does: an unused capacity row is a zero row, which quantizes to all −128
(≡ −1 mod 127), so a flip anywhere in an expert's B′ is flagged even at
a step where no token routed to that expert.

``ctx.moe_gather`` picks the dispatch: False, the GShard one-hot einsums
(the combine rounds the gate values to bf16); True, a scatter / gather
over the same slots (the combine sums in float32).  The slot assignment
is computed once, as integers, for both.  ``ctx.moe_seq_groups`` runs
the groups one at a time (JAX's scan), with the result of one block.
JAX's token-parallel constraint (``_tp``) sits at its site: on one
device and on a data mesh it moves nothing; on the dry run's meta
``DTensor`` s it redistributes the expert input.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import policy
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import Ctx
from repro_torch.layers.linear import init_linear
from repro_torch.protect import ops as pops
from repro_torch.protect.runtime import protected_call
from repro_torch.sharding.logical import constrain


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, quant: bool = False, dtype=torch.float32, device):
    """The router (float ``[d, E]``, no bias) and the gate / up / down
    expert stacks: int8 packed ``w_packed [E, k, n + 128]`` with ``alpha``
    and ``colsum [E, n]`` (``quant``), or float ``w [E, k, n]`` — the JAX
    ``init_moe``'s distributions (not its values: the generators
    differ)."""
    p = {"router": init_linear(gen, d_model, n_experts, dtype, bias=False,
                               device=device)}
    if quant:
        def q_expert(din, dout):
            ws = torch.randint(-127, 128, (n_experts, din, dout),
                               dtype=torch.int8, generator=gen,
                               device=device)
            alpha = torch.empty((n_experts, dout), dtype=torch.float32,
                                device=device)
            alpha.uniform_(1e-3, 2e-3, generator=gen)
            return {"w_packed": pops.QGEMM.encode(ws), "alpha": alpha,
                    "colsum": pops.QGEMM.dequant_colsum(ws)}
        p["gate"] = q_expert(d_model, d_ff)
        p["up"] = q_expert(d_model, d_ff)
        p["down"] = q_expert(d_ff, d_model)
        return p

    def f_expert(din, dout, scale):
        w = torch.randn((n_experts, din, dout), generator=gen,
                        device=device, dtype=torch.float32)
        return {"w": (w * scale).to(dtype)}
    p["gate"] = f_expert(d_model, d_ff, d_model ** -0.5)
    p["up"] = f_expert(d_model, d_ff, d_model ** -0.5)
    p["down"] = f_expert(d_ff, d_model, d_ff ** -0.5)
    return p


def expert_qgemm(wp, h: torch.Tensor, ctx: Ctx, name: str = "moe"):
    """The int8 part of :func:`_expert_matmul`: h ``[E, C', d_in]`` ->
    (C int32 ``[E, C', d_out]``, α_A ``[E, C']``, β_A ``[E, C']``,
    report)."""
    n_exp, rows, d_in = h.shape
    # K3 is row-wise: one call over every expert's rows
    h_q, a_alpha, a_beta = kops.quantize_rows(h.reshape(n_exp * rows, d_in))
    c, rep = protected_call("qgemm", wp["w_packed"],
                            h_q.reshape(n_exp, rows, d_in), ctx=ctx,
                            name=name)
    return (c, a_alpha.reshape(n_exp, rows), a_beta.reshape(n_exp, rows),
            rep)


def _expert_matmul(wp, h: torch.Tensor, ctx: Ctx, name: str = "moe"):
    """h [E, C', d_in] x expert weights -> ([E, C', d_out], report)."""
    if "w_packed" in wp:
        c, a_alpha, a_beta, report = expert_qgemm(wp, h, ctx, name)
        # the dequant epilogue once over [E, C', n], in JAX's order
        y = (a_alpha[..., None] * (c.to(torch.float32)
                                   * wp["alpha"][:, None, :])
             + a_beta[..., None] * (wp["alpha"] * wp["colsum"])[:, None, :])
        return y.to(ctx.compute_dtype), report
    cd = ctx.compute_dtype
    y = torch.einsum("ecd,edf->ecf", h.to(cd), wp["w"].to(cd))
    return y, policy.empty_report()


def topk_stable(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, ties to the lower index (a stable sort; ``torch.topk``
    promises no order among ties)."""
    order = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, order), order


def _route(xg: torch.Tensor, router_w: torch.Tensor, k: int):
    gate_logits = torch.einsum("gsd,de->gse", xg.to(torch.float32),
                               router_w)
    probs = torch.softmax(gate_logits, dim=-1)            # [g, G, E]
    gate_vals, gate_idx = topk_stable(probs, k)           # [g, G, k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``'s ranks, whose gradient is the sum of the
    ranks' gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _batch_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the global batch of the ranks' equal-sized means:
    their sum over ``group`` over its size.  Each rank's loss then reads
    the global batch's statistics; the sum's gradient, summed over the
    ranks, reaches each rank's own tokens, so the step's mean over the
    ranks of their gradients is the global batch's gradient."""
    import torch.distributed as dist
    n = torch.tensor(float(dist.get_world_size(group)), dtype=x.dtype,
                     device=x.device)
    return _AllReduceSum.apply(x, group) / n


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
              n_experts: int, group=None) -> torch.Tensor:
    """Switch-style load-balance loss: a product of two means over the
    batch's tokens.  On ``DTensor`` s the means are reductions over the
    sharded batch; with ``group`` (a data mesh's replicated step, each
    rank holding its rows) each mean is all-reduced over it first
    (ROADMAP §C17)."""
    frac_tokens = torch.mean(
        F.one_hot(gate_idx[..., 0], n_experts).to(torch.float32),
        dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    if group is not None:
        frac_tokens = _batch_mean(frac_tokens, group)
        frac_probs = _batch_mean(frac_probs, group)
    return n_experts * torch.sum(frac_tokens * frac_probs)


def slot_assignment(gate_idx: torch.Tensor, n_experts: int,
                    capacity: int) -> torch.Tensor:
    """Per-(token, k) expert slot: ``slot [g, G, k]`` int32 (= e·C + pos,
    or E·C for a dropped choice), JAX's ``_slot_assignment``.

    JAX walks k in order, each a cumsum over the group's tokens on top of
    the counts so far.  That order is one cumsum over (k, token): a
    choice's position is the number of earlier choices of its expert.
    JAX's counts stop at the capacity, which moves no kept position and
    drops the same choices, so one cumsum gives its slots bit for bit."""
    g, tokens, k = gate_idx.shape
    order = gate_idx.transpose(1, 2).reshape(g, k * tokens).long()
    pos = torch.cumsum(F.one_hot(order, n_experts), dim=1) - 1
    pos = torch.gather(pos, 2, order[..., None])[..., 0]        # [g, kG]
    slot = torch.where(pos < capacity, order * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return slot.reshape(g, k, tokens).transpose(1, 2).to(torch.int32)


def moe_ffn(p, x: torch.Tensor, ctx: Ctx, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor, policy.FaultReport]:
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar, report)."""
    b, s, d = x.shape
    tokens = b * s
    g_sz = min(group_size, tokens)
    n_groups = tokens // g_sz
    assert n_groups * g_sz == tokens, (tokens, g_sz)
    xg = x.reshape(n_groups, g_sz, d)

    router_w = p["router"]["w"].to(torch.float32)
    probs, gate_vals, gate_idx = _route(xg, router_w, top_k)
    aux = _aux_loss(probs, gate_idx, n_experts, ctx.data_group)

    capacity = max(int(g_sz * top_k * capacity_factor / n_experts), 4)
    capacity = min(capacity, g_sz)

    if ctx.moe_seq_groups and n_groups > 1:
        # one group's expert buffers at a time (JAX scans the groups)
        ys, reps = [], []
        for i in range(n_groups):
            y_g, rep_g = _moe_group(p, xg[i:i + 1], gate_vals[i:i + 1],
                                    gate_idx[i:i + 1], ctx, n_experts,
                                    capacity)
            ys.append(y_g[0])
            reps.append(rep_g)
        return (torch.stack(ys).reshape(b, s, d).to(ctx.compute_dtype), aux,
                policy.merge_reports(*reps))

    y, rep = _moe_group(p, xg, gate_vals, gate_idx, ctx, n_experts,
                        capacity)
    return y.reshape(b, s, d).to(ctx.compute_dtype), aux, rep


def _moe_group(p, xg, gate_vals, gate_idx, ctx: Ctx, n_experts: int,
               capacity: int):
    """Dispatch -> expert FFN -> combine for a block of groups."""
    n_groups, _, d = xg.shape
    slot = slot_assignment(gate_idx, n_experts, capacity)
    if ctx.moe_gather:
        e_in = _dispatch_gather(xg, slot, n_experts, capacity)
    else:
        e_in, combine = _dispatch_onehot(xg, gate_vals, slot, n_experts,
                                         capacity)
    # token-parallel experts only where the rules map "moe_tokens" (an
    # unconditional constraint would demand replication of the unmapped
    # dimensions), as JAX's ``_tp``
    if ctx.rules is not None and ctx.rules.get("moe_tokens") is not None:
        e_in = constrain(e_in, ("expert", "moe_tokens", None), ctx.rules)
    gate_h, r1 = _expert_matmul(p["gate"], e_in, ctx)
    up_h, r2 = _expert_matmul(p["up"], e_in, ctx)
    h = F.silu(gate_h.to(torch.float32)).to(ctx.compute_dtype) * up_h
    out, r3 = _expert_matmul(p["down"], h, ctx)             # [E, g*C, d]

    if ctx.moe_gather:
        y = _combine_gather(out, slot, gate_vals, n_groups, n_experts,
                            capacity, ctx)
    else:
        out = out.reshape(n_experts, n_groups, capacity,
                          d).transpose(0, 1)
        # a bf16 x bf16 product is exact in float32, where the sum runs
        y = torch.einsum("gsec,gecd->gsd",
                         combine.to(torch.bfloat16).to(torch.float32),
                         out.to(torch.bfloat16).to(torch.float32))
        y = y.to(ctx.compute_dtype)
    return y, policy.merge_reports(r1, r2, r3)


def _dispatch_onehot(xg, gate_vals, slot, n_experts: int, capacity: int):
    """GShard baseline: one-hot ``[g, G, E, C]`` dispatch / combine
    tensors (each (e, c) holds at most one token, so every dispatched row
    and combine weight is exact), built from the integer slots."""
    n_groups, g_sz, d = xg.shape
    ec = n_experts * capacity
    oh = F.one_hot(slot.long(), ec + 1)[..., :ec].to(torch.float32)
    dispatch = torch.sum(oh, dim=2)                          # [g, G, EC]
    combine = torch.sum(oh * gate_vals[..., None], dim=2).reshape(
        n_groups, g_sz, n_experts, capacity)
    expert_in = torch.einsum("gsx,gsd->gxd", dispatch,
                             xg.to(torch.bfloat16).to(torch.float32))
    e_in = (expert_in.reshape(n_groups, n_experts, capacity, d)
            .transpose(0, 1)
            .reshape(n_experts, n_groups * capacity, d)
            .to(torch.bfloat16))                             # [E, g*C, d]
    return e_in, combine


def _dispatch_gather(xg, slot, n_experts: int, capacity: int):
    """Index-based dispatch: scatter token ids into expert slots, gather
    rows.  JAX's scatter drops a dropped choice's slot ``E·C`` (one past
    the end); here the buffer has that one more entry, which takes the
    dropped writes and is cut off, so no index is out of range and no
    host sync is needed."""
    n_groups, g_sz, d = xg.shape
    top = slot.shape[-1]
    ec = n_experts * capacity
    token_ids = torch.arange(g_sz, dtype=torch.int32, device=xg.device)[
        None, :, None].expand(n_groups, g_sz, top).reshape(n_groups, -1)
    token_for_slot = torch.full((n_groups, ec + 1), g_sz, dtype=torch.int32,
                                device=xg.device)
    token_for_slot.scatter_(1, slot.reshape(n_groups, -1).long(), token_ids)
    token_for_slot = token_for_slot[:, :ec]
    xg_pad = torch.cat([xg, torch.zeros((n_groups, 1, d), dtype=xg.dtype,
                                        device=xg.device)], dim=1)
    rows = torch.gather(xg_pad, 1, token_for_slot.long()[..., None].expand(
        n_groups, ec, d))                                    # [g, E*C, d]
    return (rows.reshape(n_groups, n_experts, capacity, d)
            .transpose(0, 1)
            .reshape(n_experts, n_groups * capacity, d)
            .to(torch.bfloat16))


def _combine_gather(out, slot, gate_vals, n_groups: int, n_experts: int,
                    capacity: int, ctx: Ctx):
    """y[s] = Σ_k gate[s,k] · out[slot[s,k]] (dropped slots -> 0)."""
    d = out.shape[-1]
    out_g = (out.reshape(n_experts, n_groups, capacity, d)
             .transpose(0, 1)
             .reshape(n_groups, n_experts * capacity, d))
    out_pad = torch.cat([out_g, torch.zeros((n_groups, 1, d),
                                            dtype=out_g.dtype,
                                            device=out_g.device)], dim=1)
    g_sz = slot.shape[1]
    flat = slot.reshape(n_groups, -1).long()                 # [g, G*k]
    picked = torch.gather(out_pad, 1, flat[..., None].expand(
        n_groups, flat.shape[1], d)).reshape(n_groups, g_sz, -1, d)
    y = torch.sum(picked.to(torch.float32)
                  * gate_vals[..., None].to(torch.float32), dim=2)
    return y.to(ctx.compute_dtype)
