"""Plain PyTorch versions of the four CUDA kernels and of the two
unprotected instances the overhead benchmarks time (:func:`qgemm_ref`,
:func:`eb_ref`), and ``int8_dot``.

Each takes the same inputs as its kernel and returns the same outputs.
The CPU path runs them; on the card they are the reference the kernels
are held against, and nothing on the main path calls them there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import EB_REL_BOUND, LANE, MOD, column_check, \
    embedding_bag, int_matmul


def abft_qgemm_ref(a_q: torch.Tensor, b_packed: torch.Tensor,
                   with_colcheck: bool = False, mod: int = MOD):
    """Plain K1: ``(C int32 [m,n], err_rows int32 [m])``, plus the Eq.-1
    column check ``colsum(A) @ B`` (int32 [n]) when ``with_colcheck``.
    A stack of experts (``A [E, m, k]``, ``B' [E, k, n + 128]``) gives
    ``C [E, m, n]`` and ``err_rows [E, m]``, each expert on its own B'."""
    n = b_packed.shape[-1] - LANE
    c_full = int_matmul(a_q, b_packed[..., :n + 1])
    c = c_full[..., :n]
    check = c_full[..., n] % mod
    rowsum = torch.sum(c % mod, dim=-1) % mod
    err = (rowsum != check).to(torch.int32)
    if not with_colcheck:
        return c, err
    return c, err, column_check(a_q, b_packed[:, :n])


def qgemm_ref(a_q: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Plain unprotected K1: ``C = A @ B'[:, :n]`` int32 [m, n] (or a stack
    of experts, ``[E, m, n]``), the protected kernel's C without its
    check."""
    return int_matmul(a_q, b_packed[..., :b_packed.shape[-1] - LANE])


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference int8 x int8 -> int32 matmul (the JAX ``ref.int8_dot``):
    the operands widened to int32, exact."""
    return int_matmul(a, b)


def eb_ref(table_q: torch.Tensor, alphas: torch.Tensor, betas: torch.Tensor,
           indices: torch.Tensor, weights: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Plain unprotected K2: R f32 [..., bags, d] alone
    (:func:`repro_torch.core.embedding_bag`, the JAX benchmark's
    baseline)."""
    return embedding_bag(table_q, alphas, betas, indices, weights)


def abft_eb_ref(table_q: torch.Tensor, alphas: torch.Tensor,
                betas: torch.Tensor, indices: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
    """Plain K2: ``(R f32 [..., bags, d], rsum f32 [..., bags])`` for one
    table or a stack of them (see :func:`repro_torch.core.embedding_bag`)."""
    r = embedding_bag(table_q, alphas, betas, indices, weights)
    return r, torch.sum(r, dim=-1)


def _eb_slots(alphas, betas, indices, weights, rowsums=None):
    """Per slot of a stack (``alphas [tables, rows]``, ``indices [tables,
    bags, pool]``): the table and row read, alpha, beta, the weight (0 on
    a padded slot) and, with ``rowsums``, C_T as float32.  A padded slot
    reads row 0, as the plain version does; an index past the table reads
    its last row, as K2 does."""
    valid = indices >= 0
    safe = torch.where(valid, indices.long().clamp(max=alphas.shape[1] - 1),
                       0)
    t = torch.arange(alphas.shape[0], device=indices.device)[:, None, None]
    a, b = alphas[t, safe], betas[t, safe]
    w = torch.ones_like(a) if weights is None else weights
    w = torch.where(valid, w, torch.zeros_like(w))
    ct = None if rowsums is None else rowsums[t, safe].to(torch.float32)
    return safe, t, a, b, w, ct


def abft_eb_slot_order_ref(table_q: torch.Tensor, alphas: torch.Tensor,
                           betas: torch.Tensor, indices: torch.Tensor,
                           weights: Optional[torch.Tensor] = None):
    """K2's R for a stack of tables, each element summed over the slots in
    slot order from 0 (a plain loop over slots): the order K2 sums in, so
    its R equals this bit for bit.  The terms are the plain version's,
    ``w * (alpha * row + beta)``, each rounded on its own.  For tests and
    ``chip_smoke.py``; the CPU path takes :func:`abft_eb_ref`."""
    safe, t, a, b, w, _ = _eb_slots(alphas, betas, indices, weights)
    acc = torch.zeros(indices.shape[:2] + (table_q.shape[-1],),
                      dtype=torch.float32, device=table_q.device)
    for p in range(indices.shape[-1]):
        row = table_q[t[..., 0], safe[..., p]].to(torch.float32)
        acc = acc + w[..., p, None] * (a[..., p, None] * row
                                       + b[..., p, None])
    return acc


def eb_check_slot_order(rsum: torch.Tensor, alphas: torch.Tensor,
                        betas: torch.Tensor, indices: torch.Tensor,
                        rowsums: torch.Tensor, d: int,
                        weights: Optional[torch.Tensor] = None,
                        rel_bound: float = EB_REL_BOUND) -> torch.Tensor:
    """K2's Eq. (5) compare for a stack, written plainly: the terms of
    :func:`repro_torch.core.verify_bags` one for one, with ``csum`` and
    ``mag`` summed in slot order from 0 as K2 sums them.  Given K2's own
    rsum it gives K2's flags bit for bit.  -> err_bags bool [tables,
    bags]."""
    _, _, a, b, w, ct = _eb_slots(alphas, betas, indices, weights, rowsums)
    csum = torch.zeros(indices.shape[:2], dtype=torch.float32,
                       device=rsum.device)
    mag = torch.zeros_like(csum)
    for p in range(indices.shape[-1]):
        csum = csum + w[..., p] * (a[..., p] * ct[..., p] + d * b[..., p])
        mag = mag + torch.abs(w[..., p]) * (
            torch.abs(a[..., p]) * torch.abs(ct[..., p])
            + d * torch.abs(b[..., p]))
    tol = rel_bound * torch.clamp(mag, min=1.0)
    return torch.abs(rsum - csum) > tol


def eb_rsum_team_order(r: torch.Tensor, warps_per_bag: int) -> torch.Tensor:
    """K2's rsum of bags each summed by a team of ``warps_per_bag`` warps
    on 16-byte row words (``eb_plan``'s vector path with ``groups`` 1),
    written plainly from R ``[..., bags, d]`` float32: lane ``l`` of the
    team adds its words ``l, l + team, ...`` (16 columns each, in column
    order) to a 0, the 32 lanes of each warp are summed by the xor
    butterfly (offsets 16 to 1), and the warps' sums in warp order.
    Given K2's R it gives K2's rsum bit for bit.  -> f32 [..., bags]."""
    lead, d = r.shape[:-1], r.shape[-1]
    team, n_words = 32 * warps_per_bag, d // 16
    iters = -(-n_words // team)
    words = torch.nn.functional.pad(r.reshape(*lead, n_words, 16),
                                    (0, 0, 0, iters * team - n_words))
    words = words.reshape(*lead, iters, team, 16)
    mine = torch.arange(iters * team, device=r.device).reshape(
        iters, team) < n_words
    part = torch.zeros(lead + (team,), dtype=torch.float32, device=r.device)
    for it in range(iters):
        for e in range(16):
            part = torch.where(mine[it], part + words[..., it, :, e], part)
    part = part.reshape(*lead, warps_per_bag, 32)
    lane = torch.arange(32, device=r.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ off]
    rsum = part[..., 0, 0]
    for k in range(1, warps_per_bag):
        rsum = rsum + part[..., k, 0]
    return rsum


def quantize_rows_ref(x: torch.Tensor):
    """Plain K3: per-row signed-int8 affine quantization.
    f32 [m, n] -> (q int8 [m, n], alpha f32 [m], beta f32 [m])."""
    x = x.to(torch.float32)
    xmin = torch.amin(x, dim=1)
    xmax = torch.amax(x, dim=1)
    span = torch.clamp(xmax - xmin, min=1e-12)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not the IEEE quotient the JAX
    # oracle (and the kernel) computes
    alpha = span / torch.full_like(span, 255.0)
    beta = xmin + 128.0 * alpha
    q = torch.clamp(torch.round((x - beta[:, None]) / alpha[:, None]),
                    -128, 127)
    return q.to(torch.int8), alpha, beta


def wkv_chunked_ref(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    lwh: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    chunk: int = 16, mm_dtype=torch.float32):
    """Plain K4: the chunked matmul form of the WKV6 recurrence (the
    ``layers/rwkv6.wkv_chunked`` of the JAX package), differentiable.

    rh/kh/vh/lwh [B, S, H, dh] f32 (lwh the log decay), u [H, dh], state
    [B, H, dh, dh]; ``S % chunk == 0``.  With la the in-chunk cumulative
    log decay, la_prev = la - lw and la_end = la[-1], per chunk::

        y = (r e^la_prev) S + tril_-1((r e^la_prev)(k e^-la)^T) v
            + (sum r u k) v
        S = e^la_end S + (k e^(la_end - la))^T v

    r, k and v may come in bfloat16; they are cast to float32 here
    (exactly), as the JAX layer casts them.  ``mm_dtype`` bfloat16 (the
    float training layer's ``wkv_mm_bf16``) rounds the matmul operands
    to bf16 and sums in float32, as JAX's ``preferred_element_type``
    does (a product of two bf16 values is exact in float32): the scaled
    r and k, the scores and v, the bonus term's v too; the inter-chunk
    product reads the rounded r against the float32 state.  Float32 (K4's
    reference) rounds nothing.  Returns ``(y [B, S, H, dh], new_state)``.
    On the card it must run with TF32 off: its matmuls are the float32
    reference."""
    rh, kh, vh = (t.to(torch.float32) for t in (rh, kh, vh))
    b, s, h, dh = rh.shape
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"chunk={chunk}")
    n = s // chunk

    def to_chunks(x):   # [B, S, H, K] -> [n, B, H, C, K]
        return x.reshape(b, n, chunk, h, dh).permute(1, 0, 3, 2, 4)

    def mm(x):          # a matmul operand: rounded to mm_dtype
        return x.to(mm_dtype).to(torch.float32)

    rc, kc, vc, lwc = map(to_chunks, (rh, kh, vh, lwh))
    la = torch.cumsum(lwc, dim=-2)
    la_prev = la - lwc                                # la_{t-1}, la_0 = 0
    la_end = la[..., -1:, :]                          # [n, B, H, 1, K]
    r_t = mm(rc * torch.exp(la_prev))                 # bounded by |r|
    k_in = mm(kc * torch.exp(-la))                    # <= e^(C |lw_min|)
    k_st = mm(kc * torch.exp(la_end - la))            # bounded by |k|
    vm = mm(vc)
    diag = torch.sum(rc * u[None, None, :, None, :] * kc, dim=-1)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=rh.dtype,
                                 device=rh.device), diagonal=-1)
    ys = []
    for i in range(n):
        y_inter = r_t[i] @ state
        scores = (r_t[i] @ k_in[i].transpose(-1, -2)) * mask
        y = y_inter + mm(scores) @ vm[i] + diag[i][..., None] * vm[i]
        state = (torch.exp(la_end[i][..., 0, :])[..., None] * state
                 + k_st[i].transpose(-1, -2) @ vm[i])
        ys.append(y)
    y = torch.stack(ys) if ys else rh.new_zeros((0, b, h, chunk, dh))
    return y.permute(1, 0, 3, 2, 4).reshape(b, s, h, dh), state
