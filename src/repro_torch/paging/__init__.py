"""repro_torch.paging — paged, prefix-shared, per-page-checksummed KV
cache (the JAX package's ``repro.paging``).

The contiguous QuantKV cache (core.abft_kvcache) is sequence-contiguous
per fixed batcher slot: memory scales with the worst-case prompt bucket
and a verified decode read re-covers the whole prefix every step.  This
subsystem rebuilds it as a page-table cache:

  * fixed-size token **pages** of int8 QuantKV rows with per-row affine
    params and a **per-page** int32 checksum folded from the rowsums
    (one compare verifies ``page_size`` rows);
  * a host-side free-list :class:`PageAllocator` with refcounts, so
    memory scales with tokens actually resident;
  * a :class:`PrefixTree` keyed on token chunks, so requests sharing a
    system prompt share quantized+checksummed pages (copy-on-write at
    page granularity: shared pages are immutable, writers get private
    pages);
  * **verify-on-touch**: a decode read checks only the pages its
    attention mask actually covers, and a mismatched page is evicted
    and rebuilt / the owning request aborted per the ``kv_cache_paged``
    ProtectionPlan policy — never the whole lane.

The host side (allocator, tree, manager) is the JAX package's code; the
device side (:mod:`.cache`) is plain PyTorch, as the JAX package's is
XLA code with no Pallas kernel.
"""
from repro_torch.paging.alloc import PageAllocator
from repro_torch.paging.cache import (PagedKV, attend_paged,
                                      pack_prompt_pages, page_errors,
                                      paged_append, paged_pool,
                                      pool_page_bytes, reset_pages,
                                      scrub_cache)
from repro_torch.paging.manager import (AdmitPlan, PagedKVManager,
                                        PagingConfig)
from repro_torch.paging.prefixtree import PrefixTree

__all__ = [
    "PagedKV", "PageAllocator", "PrefixTree", "PagedKVManager",
    "PagingConfig", "AdmitPlan", "attend_paged", "paged_append",
    "paged_pool", "pack_prompt_pages", "page_errors", "reset_pages",
    "scrub_cache", "pool_page_bytes",
]
