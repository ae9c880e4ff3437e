"""The protected serving engine of the port: plan lanes over DLRM lookups
and LM chat requests.

:class:`ServingEngine` serves one-shot DLRM requests or, for the
``dense``, ``moe``, ``hybrid`` and ``vlm`` decoder LMs (a KV cache;
hymba's SSM state beside it), the ``encdec`` whisper (a self and a
static cross cache) and the ``ssm`` RWKV6, chat requests by continuous
batching; llava's stub patches and whisper's stub frames are drawn from
the request's seed after its tokens, as the JAX engine draws them.  Tenants (traffic
classes) carry their own :class:`~repro_torch.protect.ProtectionPlan`,
and tenants sharing a plan share a **lane**: one plan-bound set of steps
and one fixed-slot batcher.  Per engine iteration:

1. arrivals whose (virtual) time has come enter the admission queue;
2. each lane fills its free slots FIFO from the queue: a DLRM request
   runs one protected forward; a chat request runs a batch-1 prefill
   (first token = TTFT) and its KV cache or recurrent state is inserted
   into its slot of the lane's batched cache (in place, every position
   of every leaf, so no row of an earlier request survives);
3. each LM lane with active slots runs ONE batched decode step over all
   its slots; detect->act policies run inside (an ``abort`` fails the
   lane's in-flight requests, never the server);
4. finished requests retire, freeing slots for the next iteration.

The clock is hybrid: arrivals are simulated offsets, service time is the
measured wall time of each step, ended by ``torch.cuda.synchronize`` on
the card, so SLO percentiles reflect real compute under the chosen
plans.  The first steps of each lane run in :meth:`warmup`, outside the
clock.

One deliberate difference from the JAX engine: the LM lanes run with
``Ctx.wkv_chunk = cfg.wkv_chunk``, as the JAX package's int8 prefill step
does (``launch/dryrun.py``), so an RWKV prefill runs the chunked WKV form
(kernel K4 on the card) over the prompt bucket's whole chunks and the
per-token recurrence over the rest.  The JAX engine's ``Ctx(quant=True)``
leaves ``wkv_chunk`` at 0 and its serving prefill runs the recurrence
alone.  Decode (one token) runs the recurrence either way.

Fault injection is first-class: a :class:`FaultInjection` flips one bit
of a plan-path-addressed weight leaf in place before a global step (on
the engine's stream, ahead of the kernels that read it) and flips it back
after the step unless the fault is persistent, or (``target="kv"``) one
int8 payload bit of a resident request's quantized KV cache, which stays
until the slot is refilled, the page evicted or the lane dropped;
telemetry records each injection and the step that flagged it.

With ``paging=`` (a :class:`~repro_torch.paging.PagingConfig`) the LM
lanes serve from the paged, prefix-shared, page-checksummed KV cache of
:mod:`repro_torch.paging`, as the JAX engine's paged lanes do: prompts
round up to page-multiple buckets, each lane's slots hold page tables
into one pool per lane, admission looks the prompt up in the prefix tree
and packs only the pages it does not share, decode verifies the pages
its read touches, and a flagged page is scrubbed, evicted and rebuilt by
re-prefill (``recompute``/``correct``) or its owner aborted (``abort``,
or a decode-tail page) between steps.  The pools are written in place.

``run(obs=, monitor=, adapt=)`` closes the loops of the JAX engine:
``obs`` (:class:`repro_torch.obs.Observability`) lands every step's
counters — the ints the step already copied to the host, no tensor read
again — with spans, paging events and gauges; ``monitor``
(:class:`repro_torch.obs.Monitor`) turns them into alerts and tenant
health, and its transitions gate a quarantined tenant's admissions,
escalate its lane's plan (``log`` → ``recompute``) and scrub a paged
lane; ``adapt`` (:class:`repro_torch.adapt.AdaptiveThresholds`) moves the
``rel_bound`` of ops a plan marks ``threshold=adaptive``.  A plan change
rebuilds the lane's step closures (:meth:`ServingEngine._build_lane_fns`);
no kernel is rebuilt, since K2 takes ``rel_bound`` as a launch argument.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.batcher import ContinuousBatcher, Slot
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.telemetry import (InjectionRecord, RequestRecord,
                                           StepEvent, Telemetry)
from repro_torch.serving.workload import Request


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class: its protection plan and relative traffic share."""
    name: str
    plan: object = None            # ProtectionPlan (None = default_plan())
    weight: float = 1.0

    def resolved_plan(self):
        from repro_torch.protect import default_plan
        return self.plan if self.plan is not None else default_plan()


@dataclasses.dataclass
class FaultInjection:
    """Flip one bit of a weight leaf before global step ``step``.

    ``victim`` is a dotted leaf-path pattern (:mod:`repro_torch.core.inject`;
    None = the largest int8 leaf); the element and bit are drawn from
    ``seed`` over the leaf's live region.  The flip is restored after the
    step unless ``persistent`` (then :meth:`ServingEngine.reset_state`
    restores it).  ``target="kv"`` flips one int8 payload byte of a
    resident request's quantized KV cache instead (a paged lane: a byte
    of a mapped prompt page) — a memory-resident fault, persistent until
    the slot is refilled, the page evicted or the cache dropped
    (:meth:`ServingEngine.reset_state`); ``victim`` is ignored, the
    location is drawn from ``seed``, and a lane with a bf16 cache (nothing
    checksummed) takes no flip."""
    step: int
    victim: Optional[str] = None
    persistent: bool = False
    seed: int = 0
    target: str = "weights"


def tenant_weights(tenants: Sequence[TenantSpec]) -> Dict[str, float]:
    return {t.name: t.weight for t in tenants}


def _counters_of(metrics: dict) -> tuple:
    """(per-op int counters, total residual errors) from step metrics."""
    from repro_torch.core.policy import op_kinds
    out: Dict[str, int] = {}
    errors = 0
    for k in op_kinds():
        c = int(metrics.get(f"abft/{k}_checks", 0))
        e = int(metrics.get(f"abft/{k}_errors", 0))
        out[f"{k}_checks"] = c
        out[f"{k}_errors"] = e
        errors += e
    out["retries"] = int(metrics.get("abft/retries", 0))
    out["corrections"] = int(metrics.get("abft/corrections", 0))
    return out, errors


class _Lane:
    """One protection plan's slice of the engine: the plan-bound steps,
    the batcher and (LM lanes) the batched decode state on the device."""

    def __init__(self, key: str, plan, tenants: List[str], n_slots: int):
        self.key = key
        self.plan = plan
        self.tenants = set(tenants)
        self.batcher = ContinuousBatcher(n_slots)
        self.n_slots = n_slots
        self.forward_fn = None         # dlrm one-shot lanes
        self.prefill_fn = None         # LM lanes
        self.decode_fn = None
        self.cache = None
        self.tokens = None
        self.pos = None
        # paged-KV lanes (the engine fills these when paging is configured)
        self.pager = None              # PagedKVManager
        self.table = None              # [n_slots, max_pages] int32, device

    def accepts(self, req: Request) -> bool:
        return req.tenant in self.tenants

    def reset(self):
        """Drop the device-side decode state (lane reset after an abort)."""
        self.cache = None
        self.tokens = None
        self.pos = None
        self.table = None
        if self.pager is not None:
            self.pager.reset()
        return self.batcher.drain()


class ServingEngine:
    def __init__(self, cfg, tenants: Sequence[TenantSpec], *,
                 n_slots: int = 4, max_prompt: int = 64,
                 max_new_tokens: int = 32, queue_depth: int = 0,
                 seed: int = 0, compute_dtype=None, dlrm_extras=None,
                 paging=None, device="cuda"):
        from repro_torch.device import resolve_device

        self.is_dlrm = cfg.family == "dlrm"
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the DLRM Gram product and the WKV / LoRA matmuls must stay
            # full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.tenants = {t.name: t for t in tenants}
        self.n_slots = n_slots
        self.max_prompt = max_prompt
        self.max_new_tokens = max_new_tokens
        self.queue = AdmissionQueue(max_depth=queue_depth)
        self.clock_s = 0.0
        self.global_step = 0
        self._compute_dtype = (torch.bfloat16 if compute_dtype is None
                               else compute_dtype)
        self._warm = False
        #: applied injections: [(leaf, flat_index, bit, persistent)]
        self._injection_state: list = []
        #: Observability bundle for the CURRENT run (run(obs=...))
        self._obs = None
        #: detection-health Monitor for the CURRENT run (run(monitor=...))
        self._monitor = None
        #: AdaptiveThresholds controller bundle (run(adapt=...))
        self._adapt = None
        #: lane keys whose plan was already escalated (one-way per engine)
        self._escalated = set()

        #: PagingConfig | None — paged, prefix-shared, per-page-checksummed
        #: KV mode (module docstring)
        self.paging = paging
        if paging is not None:
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"paged KV serves attention-only decode caches; "
                    f"family {cfg.family!r} is not supported")
            if cfg.meta_tokens:
                raise ValueError("paged KV assumes positions start at 0 "
                                 "(meta_tokens must be 0)")
            p = paging.page_size
            self._max_bucket = -(-max_prompt // p) * p
            mp_per_slot = (self._max_bucket + max_new_tokens - 1) // p + 1
            if mp_per_slot > paging.n_pages:
                raise ValueError(
                    f"pool of {paging.n_pages} pages cannot hold even one "
                    f"slot's {mp_per_slot} pages")

        if self.is_dlrm:
            from repro_torch.configs.dlrm import EXTRAS
            from repro_torch.models.dlrm import init_dlrm
            self.dlrm_extras = dlrm_extras if dlrm_extras is not None \
                else EXTRAS
            self.model = None
            self.cache_len = 0
            self.params = init_dlrm(seed, self.dlrm_extras,
                                    device=self.device)
        else:
            from repro_torch.models.base import build_model
            # build_model raises NotImplementedError for a family the
            # port does not serve.  The KV cache holds the meta tokens,
            # the patches, the prompt bucket, the new tokens and a margin
            # of 8, as in the JAX engine; whisper's learned positions
            # reach 8 past it
            bucket = max_prompt if paging is None else self._max_bucket
            extra = cfg.meta_tokens + 8
            if cfg.family == "vlm":
                extra += cfg.n_patches
            self.cache_len = bucket + max_new_tokens + extra
            self.model = build_model(cfg, max_pos=self.cache_len + 8)
            self.params = self.model.init(seed, quant=True,
                                          device=self.device)

        # ------------------------- plan lanes --------------------------------
        by_plan: Dict[str, List[TenantSpec]] = {}
        for t in tenants:
            by_plan.setdefault(t.resolved_plan().describe(), []).append(t)
        self.lanes: List[_Lane] = []
        for i, (pkey, specs) in enumerate(sorted(by_plan.items())):
            plan = specs[0].resolved_plan()
            lane = _Lane(key=f"lane{i}[{plan.name or pkey}]", plan=plan,
                         tenants=[t.name for t in specs], n_slots=n_slots)
            if paging is not None:
                from repro_torch.paging import PagedKVManager
                p = paging.page_size
                lane.pager = PagedKVManager(
                    paging, n_slots,
                    (self._max_bucket + max_new_tokens - 1) // p + 1)
            self._build_lane_fns(lane)
            self.lanes.append(lane)
        self._lane_of = {name: lane for lane in self.lanes
                         for name in lane.tenants}

    # ------------------------------ lane steps -------------------------------

    def _build_lane_fns(self, lane: _Lane) -> None:
        from repro_torch.core.policy import metrics_to_ints

        if self.is_dlrm:
            from repro_torch.models.dlrm import dlrm_forward
            from repro_torch.protect import protect
            fwd_p = protect(functools.partial(dlrm_forward,
                                              ex=self.dlrm_extras),
                            lane.plan, compute_dtype=self._compute_dtype)

            def forward(params, dense, bags):
                logit, rep = fwd_p(params, dense, bags)
                # one device->host copy of every counter per request
                return logit, metrics_to_ints(rep.as_metrics())

            lane.forward_fn = forward
            return

        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        from repro_torch.layers.common import Ctx
        # the plan-bound serving context protect() would bind, with the
        # chunked WKV prefill (see the module docstring)
        ctx = Ctx(quant=True, plan=lane.plan,
                  compute_dtype=self._compute_dtype,
                  wkv_chunk=self.cfg.wkv_chunk)
        prefill_step = make_prefill_step(self.model, ctx,
                                         cache_len=self.cache_len)
        decode_step = make_decode_step(self.model, ctx)

        def prefill(params, batch):
            tok, cache, metrics = prefill_step(params, batch)
            return tok, cache, metrics_to_ints(metrics)

        def prefill_paged(params, batch, bucket):
            # a paged prefill runs at its prompt bucket, unpadded
            tok, cache, metrics = make_prefill_step(
                self.model, ctx, cache_len=bucket)(params, batch)
            return tok, cache, metrics_to_ints(metrics)

        def decode(params, cache, tokens, pos):
            tok, cache, metrics = decode_step(params, cache, tokens, pos)
            return tok, cache, metrics_to_ints(metrics)

        lane.prefill_fn = prefill if lane.pager is None else prefill_paged
        lane.decode_fn = decode

    @classmethod
    def _insert(cls, full, one, slot: int):
        """Write a batch-1 cache tree (dicts of tensors or of QuantKV)
        into row ``slot`` of the lane's batched cache (axis 1, after the
        layer axis), in place, every leaf of the row."""
        if isinstance(full, dict):
            for k, f in full.items():
                cls._insert(f, one[k], slot)
        elif isinstance(full, tuple):
            for f, o in zip(full, one):
                cls._insert(f, o, slot)
        else:
            full[:, slot] = one[:, 0].to(full.dtype)
        return full

    @classmethod
    def _widened_cache(cls, cache1, n_slots: int):
        """A zero cache like the batch-1 ``cache1``, ``n_slots`` wide (a
        zero QuantKV row checksums to its zero rowsum)."""
        if isinstance(cache1, dict):
            return {k: cls._widened_cache(v, n_slots)
                    for k, v in cache1.items()}
        if isinstance(cache1, tuple):
            return type(cache1)(*(cls._widened_cache(v, n_slots)
                                  for v in cache1))
        return torch.zeros((cache1.shape[0], n_slots) + cache1.shape[2:],
                           dtype=cache1.dtype, device=cache1.device)

    # ------------------------------ request payloads -------------------------

    def _chat_tokens(self, req: Request, bucket: int,
                     rng=None) -> np.ndarray:
        """The request's deterministic prompt tokens (the JAX engine's
        draws from the request's seed, or from ``rng``), padded to
        ``bucket``; a request carrying (prefix_seed, prefix_len) opens
        with the shared prompt."""
        cfg = self.cfg
        rng = np.random.default_rng(req.seed) if rng is None else rng
        pfx = min(int(req.prefix_len or 0), bucket)
        if pfx > 0 and req.prefix_seed is not None:
            head = np.random.default_rng(req.prefix_seed).integers(
                0, cfg.vocab, pfx)
            return np.concatenate(
                [head, rng.integers(0, cfg.vocab, bucket - pfx)])
        return rng.integers(0, cfg.vocab, bucket)

    def _chat_batch(self, req: Request, bucket: Optional[int] = None
                    ) -> dict:
        """One prompt, padded to ``bucket``: a paged lane's page-multiple
        bucket, else the single fixed bucket ``max_prompt``; then, from
        the same draws as JAX's, llava's stub patch features or whisper's
        stub frames."""
        cfg = self.cfg
        rng = np.random.default_rng(req.seed)
        tokens = self._chat_tokens(req, bucket or self.max_prompt, rng)
        batch = {"tokens": torch.from_numpy(
            tokens[None, :].astype(np.int32)).to(self.device)}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.n_patches, cfg.patch_dim)).astype(np.float32)).to(
                self.device)
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(
                self.device)
        return batch

    def _prefill_pos(self) -> int:
        """The first decode position: the prompt after the meta tokens
        and the patches."""
        pos = self.max_prompt + self.cfg.meta_tokens
        if self.cfg.family == "vlm":
            pos += self.cfg.n_patches
        return pos

    def _payload(self, req: Request):
        """The request's tensors on the device, validated on the host
        first: indices come from outside and feed a gather."""
        dense = np.asarray(req.payload["dense"], np.float32)
        bags = np.asarray(req.payload["bags"])
        ex = self.dlrm_extras
        if dense.ndim != 2 or dense.shape[1] != ex.n_dense:
            raise ValueError(f"request {req.rid}: dense must be "
                             f"[B, {ex.n_dense}], got {dense.shape}")
        if bags.ndim != 3 or bags.shape[:2] != (ex.n_tables,
                                                dense.shape[0]):
            raise ValueError(f"request {req.rid}: bags must be "
                             f"[{ex.n_tables}, B, pool], got {bags.shape}")
        if bags.size and (bags.max() >= ex.table_rows or bags.min() < -1):
            raise ValueError(f"request {req.rid}: bag index outside "
                             f"[-1, {ex.table_rows})")
        return (torch.from_numpy(dense).to(self.device),
                torch.from_numpy(bags.astype(np.int32)).to(self.device))

    # ------------------------------ warmup -----------------------------------

    def warmup(self, sample: Optional[Request] = None) -> None:
        """Run every lane's steps once outside the telemetry clock (the
        first call builds and loads the CUDA kernels): a DLRM forward, or
        an LM prefill of a seed-0 prompt and one decode step."""
        if self._warm:
            return
        if not self.is_dlrm:
            dummy = Request(rid=-1, tenant="_warm", arrival_s=0.0,
                            prompt_len=self.max_prompt, max_new_tokens=1,
                            seed=0)
            for lane in self.lanes:
                if lane.pager is not None:
                    self._warmup_paged(lane, dummy)
                    continue
                _, cache1, _ = lane.prefill_fn(self.params,
                                               self._chat_batch(dummy))
                full = self._insert(
                    self._widened_cache(cache1, lane.n_slots), cache1, 0)
                toks = torch.zeros((lane.n_slots,), dtype=torch.int32,
                                   device=self.device)
                pos = torch.full((lane.n_slots,), self._prefill_pos(),
                                 dtype=torch.int32, device=self.device)
                lane.decode_fn(self.params, full, toks, pos)
            self._sync()
            self._warm = True
            return
        ex = self.dlrm_extras
        if sample is not None and sample.payload is not None:
            dense, bags = self._payload(sample)
        else:
            dense = torch.zeros((1, ex.n_dense), device=self.device)
            bags = torch.zeros((ex.n_tables, 1, 1), dtype=torch.int32,
                               device=self.device)
        for lane in self.lanes:
            lane.forward_fn(self.params, torch.zeros_like(dense),
                            torch.zeros_like(bags))
        self._sync()
        self._warm = True

    def _warmup_paged(self, lane: _Lane, dummy: Request) -> None:
        """Run the paged lane's steps once (the allocator and tree are
        untouched: slot 0's warm-up pages live in a synthetic table): a
        prefill at the ``max_prompt`` bucket, the page pack and reset, a
        decode step and a scrub.  A lane without pools warms up on its own
        new pools and zeroes the pages it wrote afterwards; one that
        already holds pages warms up on throwaway pools."""
        from repro_torch.paging import scrub_cache

        p = self.paging.page_size
        bucket = self._max_bucket
        nc = bucket // p
        _, cache1, _ = lane.prefill_fn(self.params,
                                       self._chat_batch(dummy, bucket),
                                       bucket)
        own = lane.cache is None
        if own:
            self._init_paged_cache(lane, cache1)
            cache, table = lane.cache, lane.table
        else:
            cache, table = self._paged_pools(lane, cache1)
        tb = np.full(table.shape, -1, np.int32)
        tb[0, :nc + 1] = np.arange(nc + 1)
        table.copy_(torch.from_numpy(tb))
        self._pack_pages(cache, cache1, np.arange(nc))
        self._reset_pages(cache, [nc])
        toks = torch.zeros((lane.n_slots,), dtype=torch.int32,
                           device=self.device)
        pos = torch.full((lane.n_slots,), bucket, dtype=torch.int32,
                         device=self.device)
        lane.decode_fn(self.params, cache, toks, pos)
        scrub_cache(cache, pos)
        if own:
            self._reset_pages(cache, np.arange(nc + 1))
            table.fill_(-1)

    # ------------------------------ paged-KV state ---------------------------

    def _paged_pools(self, lane: _Lane, cache1):
        """Fresh zero K and V pools sized from a prefill's cache, and the
        page table both share: one ``[n_slots, max_pages]`` device tensor,
        seen by every layer through a stride-0 view (one page id names the
        same pool row in every layer)."""
        from repro_torch.core import QuantKV
        from repro_torch.paging import paged_pool

        if set(cache1) != {"attn"}:
            raise ValueError(f"paged KV expects an attention-only cache; "
                             f"got entries {sorted(cache1)}")
        leaf = cache1["attn"]["k"]
        arr = leaf.q if isinstance(leaf, QuantKV) else leaf
        ell, _, kvh, _, dh = arr.shape
        pg = self.paging
        table = torch.full((lane.n_slots, lane.pager.max_pages), -1,
                           dtype=torch.int32, device=self.device)

        def pool():
            return paged_pool(pg.n_pages, kvh, pg.page_size, dh,
                              lane.n_slots, lane.pager.max_pages,
                              n_layers=ell, device=self.device)._replace(
                table=table.expand((ell,) + table.shape))

        return {"attn": {"k": pool(), "v": pool()}}, table

    def _init_paged_cache(self, lane: _Lane, cache1) -> None:
        """Size the lane's page pools from the first prefill's cache
        shapes and zero the decode-side state."""
        lane.cache, lane.table = self._paged_pools(lane, cache1)
        lane.tokens = torch.zeros((lane.n_slots,), dtype=torch.int32,
                                  device=self.device)
        lane.pos = torch.zeros((lane.n_slots,), dtype=torch.int32,
                               device=self.device)

    def _push_table(self, lane: _Lane) -> None:
        """Copy the manager's host table into the lane's device table."""
        lane.table.copy_(torch.from_numpy(lane.pager.table))

    @staticmethod
    def _pack_pages(cache, cache1, page_ids) -> None:
        from repro_torch.paging import pack_prompt_pages
        for name in ("k", "v"):
            pack_prompt_pages(cache["attn"][name], cache1["attn"][name],
                              page_ids)

    @staticmethod
    def _reset_pages(cache, page_ids) -> None:
        from repro_torch.paging import reset_pages
        for name in ("k", "v"):
            reset_pages(cache["attn"][name], page_ids)

    def _bucket_of(self, req: Request) -> int:
        p = self.paging.page_size
        return min(self._max_bucket,
                   -(-max(int(req.prompt_len), 1) // p) * p)

    def _abort_slot(self, lane: _Lane, slot: Slot, telemetry: Telemetry):
        """Fail ONE request (pool exhausted / unrebuildable page) and free
        its slot + pages; the lane keeps serving."""
        lane.pager.retire(slot.index)
        lane.batcher.retire(slot.index)
        self._record_slot(slot, telemetry, aborted=True)

    def _publish_paging(self, lane: _Lane) -> None:
        if self._obs is None or lane.pager is None:
            return
        st = lane.pager.stats()
        g = self._obs.registry.gauge
        g("repro_paging_pages_resident",
          "allocated pages in the lane pool").set(
              st["pages_resident"], lane=lane.key)
        g("repro_paging_pages_free", "free pages in the lane pool").set(
            st["pages_free"], lane=lane.key)
        g("repro_paging_pages_shared",
          "pages referenced by more than one holder").set(
              st["pages_shared"], lane=lane.key)
        g("repro_paging_pages_high_water",
          "peak allocated pages since reset").set(
              st["pages_high_water"], lane=lane.key)
        g("repro_paging_prefix_hit_rate",
          "prompt chunks served from shared pages").set(
              st["prefix_hit_rate"], lane=lane.key)
        g("repro_paging_page_evictions",
          "pages evicted (LRU pressure + corrupt)").set(
              st["page_evictions"], lane=lane.key)
        g("repro_paging_page_rebuilds",
          "prompt re-prefills after corrupt-page eviction").set(
              st["page_rebuilds"], lane=lane.key)

    def _paging_event(self, action: str, lane: _Lane, *,
                      dur_s: float = 0.0, **attrs) -> None:
        """One paged-KV lifecycle operation (admit / evict_corrupt /
        rebuild / scrub_cache): a tracer span, a
        ``repro_paging_ops_total{action,lane}`` inc, and a typed
        ``info``/``channel=paging`` event, replayable from the JSONL."""
        if self._obs is None:
            return
        from repro_torch.obs import FaultEvent
        self._obs.tracer.add_span(
            f"paged_{action}", cat="paging",
            start_s=self.clock_s - dur_s, dur_s=dur_s, lane=lane.key,
            step=self.global_step, **attrs)
        self._obs.registry.counter(
            "repro_paging_ops_total",
            "paged-KV lifecycle operations by action and lane").inc(
                1, action=action, lane=lane.key)
        rid = attrs.get("rid")
        self._obs.bus.emit(FaultEvent(
            op=action, step=self.global_step, source="serving.engine",
            kind="info", t_s=self.clock_s,
            request_ids=(int(rid),) if rid is not None else (),
            attrs={"channel": "paging", "action": action,
                   "lane": lane.key, **attrs}))

    def _publish_injection(self, victim: str, **attrs) -> None:
        """An applied injection as a counter inc and an ``injection``
        event (what the monitor's escape proxy counts)."""
        if self._obs is None:
            return
        from repro_torch.obs import FaultEvent
        self._obs.registry.counter(
            "repro_injections_total",
            "injected faults by source").inc(1, source="serving.engine")
        self._obs.bus.emit(FaultEvent(
            op=victim, step=self.global_step, source="serving.engine",
            kind="injection", t_s=self.clock_s, attrs=attrs))

    def paging_stats(self) -> Dict[str, dict]:
        """Per-lane paging stats + byte accounting (campaign metrics)."""
        from repro_torch.paging import pool_page_bytes
        out = {}
        for lane in self.lanes:
            if lane.pager is None:
                continue
            st = lane.pager.stats()
            if lane.cache is not None:
                attn = lane.cache["attn"]
                per_page = (pool_page_bytes(attn["k"])
                            + pool_page_bytes(attn["v"]))
                st["page_bytes"] = per_page
                st["peak_resident_bytes"] = \
                    st["pages_high_water"] * per_page
            out[lane.key] = st
        return out

    # ------------------------------ fault injection --------------------------

    def _apply_injection(self, inj: FaultInjection,
                         telemetry: Telemetry) -> None:
        """Flip the injection's bit in place (one device operation on the
        current stream, so the kernels of the step see it)."""
        from repro_torch.core.inject import (draw_bitflip_live, flip_bit_,
                                             leaf_paths, victim_leaf_index)

        if inj.target == "kv":
            self._apply_kv_injection(inj, telemetry)
            return

        idx, path = victim_leaf_index(self.params, inj.victim)
        leaf = leaf_paths(self.params)[idx][1]
        gen = torch.Generator().manual_seed(inj.seed)
        flat_index, bit = draw_bitflip_live(gen, leaf, path)
        flip_bit_(leaf, flat_index, bit)
        self._injection_state.append((leaf, flat_index, bit,
                                      inj.persistent))
        telemetry.add_injection(InjectionRecord(
            step=self.global_step, victim=path, clock_s=self.clock_s,
            persistent=inj.persistent))
        self._publish_injection(path, persistent=inj.persistent,
                                seed=inj.seed)

    def _apply_kv_injection(self, inj: FaultInjection,
                            telemetry: Telemetry) -> None:
        """Flip one int8 KV payload bit of a resident request's prompt
        region, in place, with the JAX engine's draws from ``inj.seed``
        (lane, slot, pool, bit; then on a paged lane the prompt chunk and
        layer, kv head, row in the page and column; on a contiguous
        quantized lane layer, head, row and column).  The flip is
        memory-resident (no restore entry): it persists until the page is
        evicted or rebuilt, the slot refilled or the cache dropped.
        Nothing is flipped or recorded when no lane holds a quantized
        cache with a resident request."""
        from repro_torch.core import QuantKV

        rng = np.random.default_rng(inj.seed)
        lanes = [ln for ln in self.lanes
                 if ln.cache is not None and ln.batcher.occupancy()
                 and not self.is_dlrm]
        if not lanes:
            return
        lane = lanes[int(rng.integers(len(lanes)))]
        slots = lane.batcher.active_slots()
        slot = slots[int(rng.integers(len(slots)))]
        pool_name = "k" if int(rng.integers(2)) == 0 else "v"
        leaf = lane.cache["attn"][pool_name]
        bit = int(rng.integers(8))
        if lane.pager is not None:
            chunks = [c for c in
                      range(lane.pager.prompt_chunks[slot.index])
                      if lane.pager.table[slot.index, c] >= 0]
            if not chunks:
                return
            chunk = chunks[int(rng.integers(len(chunks)))]
            pid = int(lane.pager.table[slot.index, chunk])
            ell, _, kvh, pgs, dh = leaf.q.shape
            idx = (int(rng.integers(ell)), pid, int(rng.integers(kvh)),
                   int(rng.integers(pgs)), int(rng.integers(dh)))
            victim = (f"kv_page/{pool_name}/page{pid}"
                      f"/l{idx[0]}h{idx[2]}r{idx[3]}d{idx[4]}b{bit}")
        elif isinstance(leaf, QuantKV):
            ell, _, kvh, _, dh = leaf.q.shape
            row = int(rng.integers(min(slot.pos, self.max_prompt)))
            idx = (int(rng.integers(ell)), slot.index,
                   int(rng.integers(kvh)), row, int(rng.integers(dh)))
            victim = (f"kv_row/{pool_name}/slot{slot.index}"
                      f"/l{idx[0]}h{idx[2]}r{row}d{idx[4]}b{bit}")
        else:
            return                        # bf16 cache: nothing checksummed
        leaf.q[idx].bitwise_xor_((1 << bit) if bit < 7 else -128)
        telemetry.add_injection(InjectionRecord(
            step=self.global_step, victim=victim, clock_s=self.clock_s,
            persistent=True))
        self._publish_injection(victim, persistent=True, seed=inj.seed,
                                target="kv")

    def _restore_injection(self, *, include_persistent: bool = False):
        """Undo applied injections in reverse application order: transient
        ones always, persistent ones only on request (:meth:`reset_state`).
        Each flip is undone by flipping its bit again, bit for bit."""
        from repro_torch.core.inject import flip_bit_

        keep = []
        for leaf, flat_index, bit, persistent in \
                reversed(self._injection_state):
            if persistent and not include_persistent:
                keep.append((leaf, flat_index, bit, persistent))
                continue
            flip_bit_(leaf, flat_index, bit)
        self._injection_state = list(reversed(keep))

    def reset_state(self) -> None:
        """Fresh run state (clock, queue, lanes) with the built steps kept.
        Any still-applied (persistent) injected fault is restored."""
        if self._injection_state:
            self._restore_injection(include_persistent=True)
        self.clock_s = 0.0
        self.global_step = 0
        self.queue = AdmissionQueue(max_depth=self.queue.max_depth)
        for lane in self.lanes:
            lane.reset()

    # ------------------------------ engine steps -----------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        dt = time.perf_counter() - t0
        self.clock_s += dt
        return out, dt

    def _record_slot(self, slot: Slot, telemetry: Telemetry,
                     aborted: bool = False):
        req = slot.request
        telemetry.add_request(RequestRecord(
            rid=req.rid, tenant=req.tenant, kind=req.kind,
            arrival_s=req.arrival_s, admit_s=slot.admit_s,
            first_token_s=slot.first_token_s, finish_s=self.clock_s,
            prompt_len=req.prompt_len, tokens_out=slot.generated,
            queue_wait_s=slot.queue_wait_s, aborted=aborted,
            tokens=getattr(slot, "token_ids", None),
            prefill_tokens=slot.prefill_tokens,
            shared_prefix_tokens=slot.shared_prefix_tokens))

    def _step_event(self, kind: str, lane: _Lane, dt: float, metrics,
                    telemetry: Telemetry, injected: bool = False,
                    errors_override: Optional[int] = None,
                    slot_rids: tuple = ()):
        counters, errors = (_counters_of(metrics) if metrics is not None
                            else ({}, 0))
        if errors_override is not None:
            errors = errors_override
        telemetry.add_step(StepEvent(
            step=self.global_step, t_s=self.clock_s, kind=kind,
            lane=lane.key, duration_s=dt,
            occupancy=lane.batcher.occupancy(),
            queue_depth=self.queue.depth(), counters=counters,
            errors=errors, injected=injected, slot_rids=tuple(slot_rids)))
        if self._obs is not None:
            self._obs.tracer.add_span(
                kind, cat="serving", start_s=self.clock_s - dt, dur_s=dt,
                lane=lane.key, step=self.global_step,
                occupancy=lane.batcher.occupancy())
            self._obs.registry.counter(
                "repro_steps_total", "engine steps by kind").inc(
                    1, kind=kind, source="serving.engine")
            self._obs.registry.histogram(
                "repro_step_duration_ms",
                "engine step wall duration").observe(
                    dt * 1e3, kind=kind)
            if metrics is not None:
                # the ints the step copied once: no tensor is read here
                from repro_torch.protect.runtime import observe_metrics
                observe_metrics(
                    metrics, source="serving.engine",
                    step=self.global_step, t_s=self.clock_s,
                    obs=self._obs, request_ids=tuple(slot_rids),
                    attrs={"kind": kind, "lane": lane.key,
                           "duration_ms": dt * 1e3,
                           "tenants": sorted({
                               s.request.tenant
                               for s in lane.batcher.active_slots()})})
        return errors

    def _do_dlrm(self, lane: _Lane, slot_like: Slot, telemetry: Telemetry,
                 injected: bool = False):
        from repro_torch.core.policy import is_fault_abort

        req = slot_like.request
        dense, bags = self._payload(req)
        t0 = time.perf_counter()
        try:
            (_, metrics), dt = self._timed(lane.forward_fn, self.params,
                                           dense, bags)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._abort_step("dlrm", lane, t0, telemetry, injected,
                             (req.rid,))
            self._record_slot(slot_like, telemetry, aborted=True)
            return
        slot_like.first_token_s = self.clock_s
        self._record_slot(slot_like, telemetry)
        self._step_event("dlrm", lane, dt, metrics, telemetry, injected,
                         slot_rids=(req.rid,))

    def _abort_step(self, kind: str, lane: _Lane, t0: float,
                    telemetry: Telemetry, injected: bool,
                    slot_rids: tuple) -> None:
        """Policy ``abort`` fired inside a step: the step's time still
        counts, the step records one error."""
        self._sync()
        dt = time.perf_counter() - t0
        self.clock_s += dt
        self._step_event(kind, lane, dt, None, telemetry, injected,
                         errors_override=1, slot_rids=slot_rids)

    def _do_prefill(self, lane: _Lane, slot: Slot, telemetry: Telemetry,
                    injected: bool = False):
        from repro_torch.core.policy import is_fault_abort

        if lane.pager is not None:
            self._do_prefill_paged(lane, slot, telemetry, injected)
            return
        req = slot.request
        batch = self._chat_batch(req)
        t0 = time.perf_counter()
        try:
            (tok, cache1, metrics), dt = self._timed(
                lane.prefill_fn, self.params, batch)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._abort_step("prefill", lane, t0, telemetry, injected,
                             (req.rid,))
            lane.batcher.retire(slot.index)
            self._record_slot(slot, telemetry, aborted=True)
            return
        if lane.cache is None:
            lane.cache = self._widened_cache(cache1, lane.n_slots)
            lane.tokens = torch.zeros((lane.n_slots,), dtype=torch.int32,
                                      device=self.device)
            lane.pos = torch.zeros((lane.n_slots,), dtype=torch.int32,
                                   device=self.device)
        self._insert(lane.cache, cache1, slot.index)
        lane.tokens[slot.index] = tok[0]
        lane.pos[slot.index] = self._prefill_pos()
        slot.pos = self._prefill_pos()
        slot.generated = 1
        slot.first_token_s = self.clock_s
        slot.token_ids = [int(tok[0])]
        slot.prefill_tokens = self.max_prompt   # full fixed-slot bucket
        self._step_event("prefill", lane, dt, metrics, telemetry, injected,
                         slot_rids=(req.rid,))

    def _do_prefill_paged(self, lane: _Lane, slot: Slot,
                          telemetry: Telemetry, injected: bool):
        """Paged admission: prefix-tree lookup, page-bucketed prefill,
        pack the non-shared pages, allocate the first decode-tail page."""
        from repro_torch.core.policy import is_fault_abort

        req = slot.request
        pager = lane.pager
        p = self.paging.page_size
        bucket = self._bucket_of(req)
        plan = pager.admit(slot.index, self._chat_tokens(req, bucket))
        if not plan.ok:                      # pool exhausted: shed it
            lane.batcher.retire(slot.index)
            self._record_slot(slot, telemetry, aborted=True)
            return
        batch = self._chat_batch(req, bucket)
        t0 = time.perf_counter()
        try:
            (tok, cache1, metrics), dt = self._timed(
                lane.prefill_fn, self.params, batch, bucket)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._abort_step("prefill", lane, t0, telemetry, injected,
                             (req.rid,))
            self._abort_slot(lane, slot, telemetry)
            return
        if lane.cache is None:
            self._init_paged_cache(lane, cache1)
        tail = pager.decode_page(slot.index, bucket // p)
        if tail is None:
            self._abort_slot(lane, slot, telemetry)
            return
        self._pack_pages(lane.cache, cache1, plan.page_ids)
        self._push_table(lane)
        self._reset_pages(lane.cache, [tail])
        lane.tokens[slot.index] = tok[0]
        lane.pos[slot.index] = bucket
        slot.pos = bucket
        slot.generated = 1
        slot.first_token_s = self.clock_s
        slot.token_ids = [int(tok[0])]
        slot.bucket = bucket
        slot.prefill_tokens, slot.shared_prefix_tokens = plan.tokens(p)
        self._paging_event("admit", lane, slot=slot.index, rid=req.rid,
                           bucket=bucket, pages=len(plan.page_ids),
                           shared_pages=plan.shared_pages,
                           new_pages=plan.new_pages)
        self._step_event("prefill", lane, dt, metrics, telemetry, injected,
                         slot_rids=(req.rid,))
        self._publish_paging(lane)

    def _do_decode(self, lane: _Lane, telemetry: Telemetry,
                   injected: bool = False):
        from repro_torch.core.policy import is_fault_abort

        if lane.pager is not None:
            self._paged_pre_decode(lane, telemetry)
            if not lane.batcher.occupancy():
                return
        resident = tuple(s.request.rid
                         for s in lane.batcher.active_slots())
        t0 = time.perf_counter()
        try:
            (tok, cache, metrics), dt = self._timed(
                lane.decode_fn, self.params, lane.cache, lane.tokens,
                lane.pos)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._abort_step("decode", lane, t0, telemetry, injected,
                             resident)
            for slot in lane.reset():
                self._record_slot(slot, telemetry, aborted=True)
            return
        lane.cache = cache
        lane.tokens = tok
        lane.pos = lane.pos + 1
        tok_host = tok.cpu().numpy()
        for slot in lane.batcher.active_slots():
            slot.generated += 1
            slot.pos += 1
            slot.token_ids.append(int(tok_host[slot.index]))
        errors = self._step_event("decode", lane, dt, metrics, telemetry,
                                  injected, slot_rids=resident)
        if lane.pager is not None and errors > 0:
            policy = lane.plan.resolve("kv_cache_paged", "attn").policy
            if metrics.get("abft/kv_cache_paged_errors", 0) > 0 \
                    and policy != "log":
                self._paged_repair(lane, telemetry, policy)
        for slot in lane.batcher.retire_finished():
            if lane.pager is not None:
                lane.pager.retire(slot.index)
            self._record_slot(slot, telemetry)
        self._publish_paging(lane)

    def _paged_pre_decode(self, lane: _Lane, telemetry: Telemetry):
        """Before a paged decode step: allocate decode-tail pages for
        slots crossing a page boundary (aborting the owner if the pool is
        truly full), zero them, and push the current page table."""
        pager = lane.pager
        p = self.paging.page_size
        fresh = []
        for slot in list(lane.batcher.active_slots()):
            chunk = slot.pos // p
            if slot.pos % p == 0 and pager.table[slot.index, chunk] < 0:
                pid = pager.decode_page(slot.index, chunk)
                if pid is None:
                    self._abort_slot(lane, slot, telemetry)
                    continue
                fresh.append(pid)
        if not lane.batcher.occupancy():
            return
        if fresh:
            self._reset_pages(lane.cache, fresh)
        self._push_table(lane)

    def _paged_repair(self, lane: _Lane, telemetry: Telemetry,
                      policy: str):
        """Detect→act for paged KV, host-side: scrub the pool, map the
        flagged (slot, chunk) pairs to pages, then per the plan policy
        evict + rebuild shared/prompt pages via re-prefill
        (``recompute``/``correct``) or abort the owning request
        (``abort`` — and always for an unrebuildable decode-tail page).
        Only the touched requests pay; the lane keeps serving."""
        from repro_torch.paging import scrub_cache

        pager = lane.pager
        t0 = time.perf_counter()
        flags = scrub_cache(lane.cache, lane.pos)
        bad = (flags["k"] + flags["v"]).cpu().numpy()
        self._paging_event("scrub_cache", lane,
                           dur_s=time.perf_counter() - t0,
                           flagged=int((bad > 0).sum()), policy=policy)
        for slot in list(lane.batcher.active_slots()):
            chunks = [int(c) for c in np.nonzero(bad[slot.index])[0]]
            if not chunks:
                continue
            rebuild = policy != "abort"
            if rebuild:
                for c in chunks:
                    if not pager.evict_corrupt(slot.index, c):
                        rebuild = False      # corrupt decode-tail page
                self._paging_event(
                    "evict_corrupt", lane, slot=slot.index,
                    rid=slot.request.rid, chunks=chunks,
                    rebuildable=rebuild)
            if not (rebuild and self._rebuild_prompt(lane, slot,
                                                     telemetry)):
                self._abort_slot(lane, slot, telemetry)
        if lane.batcher.occupancy():
            self._push_table(lane)

    def _rebuild_prompt(self, lane: _Lane, slot: Slot,
                        telemetry: Telemetry) -> bool:
        """Re-prefill a slot's prompt onto fresh pages after a corrupt
        prompt page was evicted; decode-tail pages (the generated KV)
        survive untouched.  Returns False when the pool cannot hold the
        rebuilt pages or the re-prefill itself aborts."""
        from repro_torch.core.policy import is_fault_abort

        pager = lane.pager
        req = slot.request
        bucket = slot.bucket
        pager.release_prompt(slot.index)
        plan = pager.readmit(slot.index, self._chat_tokens(req, bucket))
        if not plan.ok:
            return False
        t0 = time.perf_counter()
        try:
            (_, cache1, metrics), dt = self._timed(
                lane.prefill_fn, self.params,
                self._chat_batch(req, bucket), bucket)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._sync()
            self.clock_s += time.perf_counter() - t0
            return False
        self._pack_pages(lane.cache, cache1, plan.page_ids)
        self._push_table(lane)
        self._paging_event("rebuild", lane, dur_s=dt, slot=slot.index,
                           rid=req.rid, pages=len(plan.page_ids))
        self._step_event("rebuild", lane, dt, metrics, telemetry,
                         slot_rids=(req.rid,))
        return True

    # ------------------------------ monitor responses ------------------------

    def _admits(self, lane: _Lane):
        """The lane's admission predicate, gated by tenant health when a
        monitor is attached (quarantined tenants only pass as recovery
        probes)."""
        if self._monitor is None:
            return lane.accepts
        mon = self._monitor
        return lambda req: (lane.accepts(req)
                            and mon.admission_allowed(req.tenant))

    def _health_action(self, action: str, scope: str,
                       lane: _Lane) -> None:
        """Record one applied engine response (quarantine / escalate /
        scrub / recover) as a counter and a typed health event."""
        if self._obs is None:
            return
        from repro_torch.obs import FaultEvent
        self._obs.registry.counter(
            "repro_health_actions_total",
            "engine responses to health transitions").inc(
                1, action=action, scope=scope)
        self._obs.bus.emit(FaultEvent(
            op="health", step=self.global_step, source="serving.engine",
            kind="health", t_s=self.clock_s,
            attrs={"scope": scope, "action": action, "lane": lane.key}))

    def _escalate_lane(self, lane: _Lane) -> bool:
        """Upgrade the lane's plan detect→act policies (``log`` →
        ``recompute``) and rebuild its step closures; one-way per engine.
        The escalated plan switches no op on or off, so the lane's cache
        and batch are kept."""
        if lane.key in self._escalated:
            return False
        lane.plan = lane.plan.escalated()
        self._build_lane_fns(lane)
        self._escalated.add(lane.key)
        return True

    def _apply_monitor_responses(self, telemetry: Telemetry) -> None:
        """Drain the monitor's health transitions and apply the
        configured responses to the owning tenant lanes."""
        from repro_torch.obs.health import HEALTH_STATES

        mon = self._monitor
        for tr in mon.poll_transitions():
            if not tr.scope.startswith("tenant:"):
                continue
            tenant = tr.scope.split(":", 1)[1]
            lane = self._lane_of.get(tenant)
            if lane is None:
                continue
            worse = (HEALTH_STATES.index(tr.new)
                     > HEALTH_STATES.index(tr.old))
            if not worse:
                self._health_action("recover", tr.scope, lane)
                continue
            if tr.new == "quarantined" and mon.responses.quarantine:
                self._health_action("quarantine", tr.scope, lane)
            if mon.responses.escalate and self._escalate_lane(lane):
                self._health_action("escalate", tr.scope, lane)
            if mon.responses.scrub and lane.pager is not None \
                    and lane.cache is not None:
                self._paged_repair(lane, telemetry, "recompute")
                self._health_action("scrub", tr.scope, lane)

    # ------------------------------ adaptive thresholds ----------------------

    def _register_adaptive(self) -> None:
        """One controller per (op, tenant) whose lane plan opts the op
        into ``threshold=adaptive``, seeded from the plan's resolved
        ``rel_bound`` (or the op default) unless the caller pre-seeded
        the controller (e.g. from ``calibrate_from_sweep``)."""
        from repro_torch.adapt import _op_default_bound
        from repro_torch.core.policy import op_kinds
        for lane in self.lanes:
            for op in op_kinds():
                r = lane.plan.resolve(op)
                if not (r.enabled and r.threshold == "adaptive"):
                    continue
                current = (r.rel_bound if r.rel_bound is not None
                           else _op_default_bound(op))
                for tenant in sorted(lane.tenants):
                    c = self._adapt.manage(op, tenant,
                                           rel_bound=r.rel_bound)
                    # the lane runs at the controller's bound (which may
                    # predate this run via calibration)
                    if c.rel_bound != current:
                        self._apply_bound(op, tenant, c.rel_bound)

    def _apply_bound(self, op: str, tenant: str, bound: float) -> None:
        """Rewrite one tenant lane's plan with the controller's bound and
        rebuild its step closures, as :meth:`_escalate_lane` does; the
        kernels take the bound as a launch argument."""
        from repro_torch.protect.plan import OpRule

        lane = self._lane_of.get(tenant)
        if lane is None:
            return
        lane.plan = lane.plan.with_rules(
            OpRule(pattern=op, rel_bound=float(bound)))
        self._build_lane_fns(lane)

    def _apply_adaptive(self) -> None:
        if self._adapt is None or self._monitor is None:
            return
        moved = self._adapt.tick(self._monitor, t_s=self.clock_s,
                                 step=self.global_step)
        for (op, tenant), bound in moved.items():
            self._apply_bound(op, tenant, bound)

    # ------------------------------ main loop --------------------------------

    def run(self, requests: Sequence[Request], *,
            inject: Optional[Sequence[FaultInjection]] = None,
            telemetry: Optional[Telemetry] = None, warmup: bool = True,
            max_iterations: int = 1_000_000,
            obs=None, monitor=None, adapt=None) -> Telemetry:
        """Serve ``requests`` to completion and return the timeline, with
        the ``inject`` faults applied at their global steps.

        ``obs`` (a :class:`repro_torch.obs.Observability`) lands every
        step's counters, spans and per-request-attributed detection
        events host-side for this run.  ``monitor`` (a
        :class:`repro_torch.obs.Monitor`) is bound to ``obs`` (one is
        created if the caller passed none), fed by the step summaries
        over the bus, and its health transitions trigger responses
        between iterations: gate a quarantined tenant's admissions (with
        recovery probes), escalate the lane's plan (``log`` →
        ``recompute``), scrub a paged lane.  ``adapt`` (a
        :class:`repro_torch.adapt.AdaptiveThresholds`, needs ``monitor``)
        gives every (op, tenant) whose plan marks the op
        ``threshold=adaptive`` an FP-budget controller over its
        ``rel_bound``, ticked each iteration.  The monitor's and the
        controllers' summaries land on the returned telemetry."""
        telemetry = telemetry if telemetry is not None else Telemetry()
        if adapt is not None and monitor is None:
            raise ValueError("adapt= needs monitor= (its sensor)")
        injections = sorted(inject or [], key=lambda j: j.step)
        for inj in injections:
            if inj.target not in ("weights", "kv"):
                raise ValueError(f"unknown injection target "
                                 f"{inj.target!r}; have ('weights', 'kv')")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        for r in pending:
            if r.tenant not in self._lane_of:
                raise ValueError(f"request {r.rid} names unknown tenant "
                                 f"{r.tenant!r}; have "
                                 f"{sorted(self._lane_of)}")
            if (r.kind == "dlrm") != self.is_dlrm:
                raise ValueError(
                    f"request {r.rid}: a {self.cfg.family} engine does not "
                    f"serve {r.kind!r} requests")
        if warmup:
            self.warmup(pending[0] if pending else None)
        if monitor is not None and obs is None:
            from repro_torch.obs import Observability
            obs = Observability.create()
        self._obs = obs
        self._monitor = monitor
        if monitor is not None:
            monitor.bind(obs)
        self._adapt = adapt
        try:
            if adapt is not None:
                adapt.bind(obs)
                self._register_adaptive()
            out = self._run_loop(pending, injections, telemetry,
                                 max_iterations)
            if monitor is not None:
                out.monitor = monitor.summary()
            if adapt is not None:
                out.thresholds = adapt.summary()
            return out
        finally:
            # a transient flip never outlives the run, even one that raised
            self._restore_injection()
            self._obs = None
            self._monitor = None
            self._adapt = None

    def _run_loop(self, pending, injections, telemetry,
                  max_iterations) -> Telemetry:
        i = 0
        it = 0
        inj_i = 0
        while True:
            it += 1
            if it > max_iterations:
                raise RuntimeError("engine exceeded max_iterations "
                                   "(stuck request stream?)")
            # 1. arrivals whose time has come; a full bounded queue sheds
            #    load — the rejection IS the SLO story, so it is recorded
            while i < len(pending) and pending[i].arrival_s <= self.clock_s:
                req = pending[i]
                if not self.queue.push(req, self.clock_s):
                    telemetry.add_request(RequestRecord(
                        rid=req.rid, tenant=req.tenant, kind=req.kind,
                        arrival_s=req.arrival_s, admit_s=self.clock_s,
                        first_token_s=None, finish_s=self.clock_s,
                        prompt_len=req.prompt_len, tokens_out=0,
                        queue_wait_s=0.0, aborted=True, rejected=True))
                i += 1
            active = any(lane.batcher.occupancy() for lane in self.lanes)
            if not self.queue and not active:
                if i >= len(pending):
                    break
                # idle: jump the virtual clock to the next arrival
                self.clock_s = max(self.clock_s, pending[i].arrival_s)
                continue

            injected_now = (inj_i < len(injections)
                            and injections[inj_i].step <= self.global_step)
            if injected_now:
                self._apply_injection(injections[inj_i], telemetry)
                inj_i += 1

            clock_before = self.clock_s
            # 2. admissions: a one-shot dlrm forward, or an LM prefill; a
            #    quarantined tenant's requests stay queued, but for the
            #    monitor's periodic recovery probes
            for lane in self.lanes:
                for slot in lane.batcher.admit(self.queue, self.clock_s,
                                               accept=self._admits(lane)):
                    if slot.request.kind == "dlrm":
                        lane.batcher.retire(slot.index)
                        self._do_dlrm(lane, slot, telemetry, injected_now)
                    else:
                        self._do_prefill(lane, slot, telemetry,
                                         injected_now)
                for slot in lane.batcher.retire_finished():
                    if lane.pager is not None:
                        lane.pager.retire(slot.index)
                    self._record_slot(slot, telemetry)

            # 3. one decode step per lane with active slots
            for lane in self.lanes:
                if lane.batcher.occupancy():
                    self._do_decode(lane, telemetry, injected_now)

            if self._monitor is not None:
                if self.clock_s == clock_before and (
                        self.queue or any(ln.batcher.occupancy()
                                          for ln in self.lanes)):
                    # a fully gated iteration stepped nothing, so nothing
                    # ticked the monitor: advance the clock a hair and
                    # tick it, so probes and recovery can unlock
                    self.clock_s += 1e-3
                    self._monitor.idle_tick(self.clock_s)
                self._apply_monitor_responses(telemetry)
                self._apply_adaptive()

            if injected_now:
                self._restore_injection()
            self.global_step += 1

        telemetry.finalize_injections()
        return telemetry


__all__ = ["ServingEngine", "TenantSpec", "FaultInjection",
           "tenant_weights"]
