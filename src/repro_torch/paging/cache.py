"""Device-side paged KV cache: page pools, per-page checksums, attention
(the JAX package's ``paging/cache.py``).

Layout (per layer; the engine's pools stack a leading ``L`` on every
leaf, the page table included):

    q        int8  [n_pages, Kv, P, dh]   quantized rows (core.abft_kvcache)
    alpha    f32   [n_pages, Kv, P]       per-row affine scale
    beta     f32   [n_pages, Kv, P]       per-row affine offset
    pagesum  int32 [n_pages, Kv]          ABFT page checksum = Σ_rows rowsum
    table    int32 [B, max_pages]         page ids per slot, -1 = unmapped

One page id names the same pool row in every layer's K and V pools: a
page is a block of ``P`` token positions across the whole model, so the
host allocator hands out a single id per token block.  The page checksum
folds the paper's Alg.-2 rowsums one level further: one int32 compare
verifies ``P`` rows of ``dh`` int8 elements, which is what makes
verify-on-touch cheap enough to run on every decode read.

Two departures from the JAX functions, neither visible in their results:

* **Writes land in place.**  :func:`pack_prompt_pages`,
  :func:`reset_pages` and :func:`paged_append` write the pool's own
  tensors (a per-layer view writes through to the stacked pool) and
  return it, where JAX returns new arrays: the serving engine holds the
  only reference, and a decode step then copies no pool.
* **Skipped writes are masked, not sent out of range.**  JAX drops a
  scatter update whose page id is ``n_pages`` (a prefix page already
  resident, an unmapped slot); torch's indexing refuses such an id.
  Page ids that come from the host (:func:`pack_prompt_pages`,
  :func:`reset_pages`) are filtered there, so a skipped page is never
  indexed.  :func:`paged_append` finds its pages on the device, in the
  table, and masks the writes of unmapped slots without a host sync:
  each such write repeats a kept write of the same call (same place,
  same bytes) or, when the call keeps none, rewrites page 0's row 0 with
  its own bytes, and adds 0 to a checksum.  No byte of any page changes
  for it.

Gathers clip table ids to ``[0, n_pages - 1]`` as JAX's do, and every
clipped (unmapped) page is masked out of the checksum counts and the
attention.  The attention arithmetic is plain float32 PyTorch: the JAX
package runs it as XLA code, with no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.abft_kvcache import QuantKV, quantize_kv_rows
from repro_torch.device import resolve_device

NEG_INF = -1e30


class PagedKV(NamedTuple):
    q: torch.Tensor        # int8  [n_pages, Kv, P, dh]
    alpha: torch.Tensor    # f32   [n_pages, Kv, P]
    beta: torch.Tensor     # f32   [n_pages, Kv, P]
    pagesum: torch.Tensor  # int32 [n_pages, Kv]
    table: torch.Tensor    # int32 [B, max_pages], -1 = unmapped


def paged_pool(n_pages: int, n_kv: int, page_size: int, head_dim: int,
               n_slots: int, max_pages: int, n_layers: int = 0, *,
               device="cuda") -> PagedKV:
    """A zeroed pool with an all-unmapped table on ``device``.
    ``n_layers > 0`` stacks a leading layer axis on every leaf."""
    dev = resolve_device(device)
    lead = (n_layers,) if n_layers else ()
    return PagedKV(
        q=torch.zeros(lead + (n_pages, n_kv, page_size, head_dim),
                      dtype=torch.int8, device=dev),
        alpha=torch.zeros(lead + (n_pages, n_kv, page_size),
                          dtype=torch.float32, device=dev),
        beta=torch.zeros(lead + (n_pages, n_kv, page_size),
                         dtype=torch.float32, device=dev),
        pagesum=torch.zeros(lead + (n_pages, n_kv), dtype=torch.int32,
                            device=dev),
        table=torch.full(lead + (n_slots, max_pages), -1,
                         dtype=torch.int32, device=dev),
    )


def _kept_pages(page_ids, n_pages: int, device):
    """(positions in ``page_ids``, page ids) of the entries below
    ``n_pages``, selected on the host; ids at ``n_pages`` or past it are
    the skip sentinel."""
    ids = torch.as_tensor(page_ids).to("cpu", torch.int64).reshape(-1)
    keep = torch.nonzero(ids < n_pages).reshape(-1)
    return keep.to(device), ids[keep].to(device)


def pack_prompt_pages(pool: PagedKV, src, page_ids) -> PagedKV:
    """Write a prefilled prompt's rows into pool pages (stacked layout),
    in place; returns ``pool``.

    ``pool`` leaves carry a leading L; ``src`` is the batch-1 prefill
    cache entry — a QuantKV (or float tensor to quantize here) with
    leaves [L, 1, Kv, S, dh] where S is a multiple of the page size.
    ``page_ids`` [S // P] (host values) maps prompt chunk -> pool page;
    entries >= n_pages are skipped (chunk already resident via the prefix
    tree).  The table is left untouched — mapping is the host
    allocator's job."""
    n_pages, page = pool.q.shape[1], pool.q.shape[3]
    if not isinstance(src, QuantKV):
        src = quantize_kv_rows(src.to(torch.float32))
    ell, _, kv, s, dh = src.q.shape
    nc = s // page
    q = src.q.reshape(ell, kv, nc, page, dh).permute(0, 2, 1, 3, 4)
    alpha = src.alpha.reshape(ell, kv, nc, page).permute(0, 2, 1, 3)
    beta = src.beta.reshape(ell, kv, nc, page).permute(0, 2, 1, 3)
    pagesum = torch.sum(src.rowsum.reshape(ell, kv, nc, page), dim=-1,
                        dtype=torch.int32).permute(0, 2, 1)
    chunks, pids = _kept_pages(page_ids, n_pages, pool.q.device)
    pool.q[:, pids] = q[:, chunks]
    pool.alpha[:, pids] = alpha[:, chunks]
    pool.beta[:, pids] = beta[:, chunks]
    pool.pagesum[:, pids] = pagesum[:, chunks]
    return pool


def reset_pages(pool: PagedKV, page_ids) -> PagedKV:
    """Zero freshly-allocated pages (stacked layout), in place, so decode
    appends accumulate pagesums from a clean slate.  ``page_ids`` are host
    values; sentinel ids (>= n_pages) are skipped.  Returns ``pool``."""
    _, pids = _kept_pages(page_ids, pool.q.shape[1], pool.q.device)
    for leaf in (pool.q, pool.alpha, pool.beta, pool.pagesum):
        leaf[:, pids] = 0
    return pool


def paged_append(pk: PagedKV, pos: torch.Tensor,
                 new_rows: torch.Tensor) -> PagedKV:
    """Decode-step append into the mapped page (per-layer layout), in
    place; returns ``pk``.

    new_rows [B, Kv, dh] float; pos [B] is the write position (its chunk
    clipped to the table, as JAX's gather clips it).  The write of a slot
    whose table entry is unmapped (a retired slot) is masked out (module
    docstring).  The page checksum is maintained incrementally: pagesum
    += rowsum of the new row."""
    page = pk.q.shape[2]
    b = new_rows.shape[0]
    nq = quantize_kv_rows(new_rows)                    # leaves [B, Kv, ...]
    rows = torch.arange(b, device=pos.device)
    chunk = torch.clamp(torch.div(pos, page, rounding_mode="floor"),
                        max=pk.table.shape[1] - 1).long()
    pid = pk.table[rows, chunk].long()
    off = torch.remainder(pos, page).long()
    keep = pid >= 0
    # a masked write repeats the first kept write (or, with none kept,
    # rewrites page 0 row 0 with its own bytes): equal writes in any order
    any_kept = keep.any()
    # (index_select: indexing by a 0-d tensor would read it on the host)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    tgt_pid = torch.where(keep, pid, torch.where(
        any_kept, pid.index_select(0, first), 0))
    tgt_off = torch.where(keep, off, torch.where(
        any_kept, off.index_select(0, first), 0))
    src = torch.where(keep, rows, first)
    for leaf, new in ((pk.q, nq.q), (pk.alpha, nq.alpha),
                      (pk.beta, nq.beta)):
        leaf[tgt_pid, :, tgt_off] = torch.where(any_kept, new[src],
                                                leaf[0, :, 0])
    pk.pagesum.index_add_(0, tgt_pid,
                          torch.where(keep[:, None], nq.rowsum, 0))
    return pk


def _touched(table: torch.Tensor, pos: torch.Tensor,
             page: int) -> torch.Tensor:
    """Verify-on-touch mask [..., B, MP]: mapped pages at or below the
    read frontier ``pos`` [B]."""
    start = torch.arange(table.shape[-1], device=table.device) * page
    return (table >= 0) & (start <= pos[:, None])


def _page_mismatches(pk: PagedKV, pos: torch.Tensor) -> torch.Tensor:
    """bool [..., B, MP, Kv]: touched (page, kv head) checksums that
    disagree with the recomputed fold; per-layer or stacked leaves."""
    n_pages, _, page = pk.q.shape[-4:-1]
    safe = torch.clamp(pk.table, 0, n_pages - 1).long()
    if pk.q.dim() == 5:                     # stacked: each layer's table
        li = torch.arange(pk.q.shape[0], device=safe.device)[:, None, None]
        q, want = pk.q[li, safe], pk.pagesum[li, safe]
    else:
        q, want = pk.q[safe], pk.pagesum[safe]
    got = torch.sum(q, dim=(-1, -2), dtype=torch.int32)
    return (got != want) & _touched(pk.table, pos, page)[..., None]


def page_errors(pk: PagedKV, pos: torch.Tensor) -> torch.Tensor:
    """Per-(slot, chunk) checksum mismatches among touched pages.

    pos [B] -> int32 [B, max_pages]: how many (page, kv-head) checksums
    disagree with the recomputed fold.  Verify-on-touch masking: only
    mapped pages at or below the read frontier count."""
    return torch.sum(_page_mismatches(pk, pos), dim=-1, dtype=torch.int32)


def attend_paged(q_heads: torch.Tensor, pk: PagedKV, pv: PagedKV,
                 pos: torch.Tensor, *, n_heads: int, n_kv: int,
                 verify: bool = True, window=None, prefix_global: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode attention off the paged int8 pools.

    q_heads [B, H, dh]; returns (out [B, H, dh] f32, err_count int32,
    pages_verified int32).  Same affine score expansion as
    :func:`~repro_torch.core.abft_kvcache.attend_quantized` —
    ``q·k_row = α_row (q·k_q_row) + β_row Σ_d q_d`` — but the
    contraction runs over gathered pages and the ABFT check is ONE int32
    compare per touched (page, kv head) instead of one per row.
    ``pages_verified`` counts touched pages over both pools."""
    b, h, dh = q_heads.shape
    g = n_heads // n_kv
    n_pages, kvh, page = pk.q.shape[:3]
    mp = pk.table.shape[1]
    dev = q_heads.device
    safe = torch.clamp(pk.table, 0, n_pages - 1).long()
    mapped = pk.table >= 0                                   # [B, MP]
    kq = pk.q[safe]                                 # [B, MP, Kv, P, dh]
    vq = pv.q[safe]

    errs = torch.zeros((), dtype=torch.int32, device=dev)
    pages = torch.zeros((), dtype=torch.int32, device=dev)
    if verify:
        touched = _touched(pk.table, pos, page)[..., None]
        err_k = (torch.sum(kq, dim=(-1, -2), dtype=torch.int32)
                 != pk.pagesum[safe]) & touched
        err_v = (torch.sum(vq, dim=(-1, -2), dtype=torch.int32)
                 != pv.pagesum[safe]) & touched
        errs = (torch.sum(err_k, dtype=torch.int32)
                + torch.sum(err_v, dtype=torch.int32))
        pages = 2 * torch.sum(touched, dtype=torch.int32)

    # gathered pages -> grouped sequence layout [B, Kv, MP*P, *]
    def seq(x):
        return x.transpose(1, 2).reshape((b, kvh, mp * page) + x.shape[4:])

    ks, vs = seq(kq), seq(vq)
    ka, kb = seq(pk.alpha[safe]), seq(pk.beta[safe])
    va, vb = seq(pv.alpha[safe]), seq(pv.beta[safe])

    qg = q_heads.reshape(b, n_kv, g, dh).to(torch.float32)
    qk_int = torch.matmul(qg, ks.to(torch.float32).transpose(-1, -2))
    qsum = torch.sum(qg, dim=-1)                              # [B, Kv, g]
    s = (ka[:, :, None, :] * qk_int
         + kb[:, :, None, :] * qsum[..., None]) * dh ** -0.5

    kv_pos = torch.arange(mp * page, device=dev)[None, None, None, :]
    qp = pos[:, None, None, None]
    in_map = mapped[:, :, None].expand(b, mp, page).reshape(
        b, 1, 1, mp * page)
    valid = in_map & (kv_pos <= qp)
    if window is not None:
        in_win = (qp - kv_pos) < window
        if prefix_global > 0:
            in_win = in_win | (kv_pos < prefix_global)
        valid = valid & in_win
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)                        # [B, Kv, g, MP*P]

    pv_int = torch.matmul(p * va[:, :, None, :], vs.to(torch.float32))
    pbeta = torch.sum(p * vb[:, :, None, :], dim=-1)
    out = pv_int + pbeta[..., None]
    return out.reshape(b, h, dh), errs, pages


def scrub_cache(cache, pos: torch.Tensor):
    """Whole-pool page verify for the engine's evict/rebuild path.

    ``cache`` is the stacked attn cache ({"attn": {"k": PagedKV, "v":
    PagedKV}} with leading-L leaves); returns {"k": [B, MP], "v": ...}
    int32 mismatch counts summed over layers — the host maps flagged
    (slot, chunk) pairs back to page ids and applies the plan policy."""
    attn = cache["attn"]
    return {name: torch.sum(page_errors(attn[name], pos), dim=0,
                            dtype=torch.int32) for name in ("k", "v")}


def pool_page_bytes(pool: PagedKV) -> int:
    """Bytes one page owns in this pool (table excluded) — the unit the
    allocator's high-water mark converts to peak resident KV bytes."""
    axis = 1 if pool.q.dim() == 5 else 0
    total = 0
    for leaf in (pool.q, pool.alpha, pool.beta, pool.pagesum):
        total += (leaf.numel() // leaf.shape[axis]) * leaf.element_size()
    return int(total)
