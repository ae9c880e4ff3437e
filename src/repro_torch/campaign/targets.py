"""Registry of injectable targets: the paper's main path.

A target owns what a campaign cell needs:

* ``build(plan, gen, *, device, plain=False)`` — the operand state of one
  cell (weights, tables, precomputed checksums), drawn from the CPU
  generator ``gen`` and moved to ``device``.  The protected calls run the
  CUDA kernels (K1, K2) where the operands are CUDA tensors, and the plain
  versions elsewhere or when ``plain`` asks for them;
* ``draw(state, plan, gen, n, faulty)`` — ``n`` trials' coordinates
  (:class:`Trial`): the fault of each (element index and bit, or
  replacement value) and, for the EmbeddingBag, its bags.  ``faulty=False``
  draws clean runs.  A test can hand fixed coordinates to ``trial``;
* ``trial(state, plan, t)`` — inject ``t``'s faults in place, run the
  protected op, restore the state exactly, and return ``(detected,
  corrupted)``: ``corrupted`` is the target's ground truth for "did the
  fault change anything", which separates masked faults from escapes.
  On a clean trial ``detected`` is the false positive.

``overhead`` optionally returns (protected, unprotected) thunks and
``overhead_phases`` named phase thunks, which the executor times.

The JAX package's trials corrupt a copy of the state; here the victim is
flipped in place and flipped back, so no trial copies its operands.  Its
``gemm_pallas`` / ``eb_pallas`` names the kernel targets: on the card they
and ``gemm_packed`` / ``embedding_bag`` all run the kernels (the port's
default scheme is the kernel wherever the operands are CUDA tensors), so
they differ by their cell seeds and phase columns only.  On the CPU all
run the plain versions, because their tensors lie on the CPU.

``kv_cache`` flips a bit of the quantized KV cache's payload (int8) or of
its dequant scales (float32, outside the rowsum: the deliberate coverage
gap) and runs the cache's verify.  ``decode_step`` runs the reduced
Llama-3.2-1B's protected decode with a flip in one weight leaf, over
``plan.steps`` steps (the soak protocol, ``soak``): per step whether any
check fired, and whether the greedy tokens left the clean twin run's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.campaign.spec import CellPlan
from repro_torch.core import abft_gemm as ag
from repro_torch.core.abft_kvcache import verify_kv
from repro_torch.core.inject import (bit_band, bit_mask, draw_bitflip_live,
                                     draw_bitflips, draw_value, signed_view)
from repro_torch.protect.ops import EMBEDDING_BAG, KV_CACHE, LANE, QGEMM
from repro_torch.protect.plan import ResolvedRule


class Fault(NamedTuple):
    """One corrupted element: flat ``index`` into the target's victim, and
    ``bit`` to flip, or (``bit`` = -1) the signed bit pattern ``value`` that
    replaces the element."""
    index: int
    bit: int = -1
    value: int = 0


class Trial(NamedTuple):
    """One trial's coordinates: its faults (none on a clean trial) and, for
    the EmbeddingBag targets, the bags ``[bags, pool]`` on the device."""
    faults: Tuple[Fault, ...] = ()
    indices: Optional[torch.Tensor] = None


def draw_faults(gen: torch.Generator, victim: torch.Tensor,
                plan: CellPlan, path: str = "") -> Tuple[Fault, ...]:
    """The spec'd fault model's coordinates on ``victim`` (any tensor of
    the victim's shape and dtype, a ``meta`` one included).  ``path``,
    the victim leaf's dotted path, keeps a single flip off the dead
    alignment lanes of a packed weight (``draw_bitflip_live``); with no
    path the draw is a plain ``draw_bitflip``."""
    if plan.fault_model == "bitflip":
        rng = bit_band(victim.dtype, plan.bit_band)
        if plan.flips == 1:
            return (Fault(*draw_bitflip_live(gen, victim, path, rng)),)
        return tuple(Fault(i, b) for i, b in
                     draw_bitflips(gen, victim, plan.flips, rng))
    if plan.fault_model == "random_value":
        idx, value = draw_value(gen, victim)
        return (Fault(idx, value=value),)
    raise ValueError(f"unknown fault model {plan.fault_model!r}")


def inject_(flat: torch.Tensor, faults, nbits: int):
    """Apply ``faults`` (indices into ``flat``, a signed view) in place.

    Returns ``(undo, corrupted)``: what :func:`restore_` needs, and whether
    any element changed (a bool, or a bool tensor on the device when a
    replacement value may equal the element it replaces)."""
    undo, changed = [], []
    for f in faults:
        el = flat[f.index]
        if f.bit >= 0:
            el.bitwise_xor_(bit_mask(f.bit, nbits))
            undo.append((el, None, f.bit))
            changed.append(True)
        else:
            old = el.clone()
            el.fill_(f.value)
            undo.append((el, old, -1))
            changed.append(old != f.value)
    if not changed:
        return undo, False
    if all(c is True for c in changed):
        return undo, True
    return undo, functools.reduce(torch.logical_or, (
        torch.as_tensor(c, device=flat.device) for c in changed))


def restore_(undo, nbits: int) -> None:
    """Undo :func:`inject_`, in reverse order: every element is restored
    bit for bit."""
    for el, old, bit in reversed(undo):
        if old is None:
            el.bitwise_xor_(bit_mask(bit, nbits))
        else:
            el.copy_(old)


@dataclasses.dataclass(frozen=True)
class InjectableTarget:
    name: str
    build: Optional[Callable[..., Any]] = None
    draw: Optional[Callable[..., List[Trial]]] = None
    trial: Optional[Callable[[Any, CellPlan, Trial], tuple]] = None
    #: the soak protocol (multi-step targets): ``soak(state, plan, t) ->
    #: {"detected_steps": bool [steps], "corrupted": bool, "divergence":
    #: f32}``, on the device; the executor runs it for the faulty trials
    #: (``trial`` still runs the clean ones)
    soak: Optional[Callable[[Any, CellPlan, Trial], dict]] = None
    default_shapes: Tuple[Tuple[int, ...], ...] = ()
    shape_arity: int = 0
    dtypes: Tuple[str, ...] = ("int8",)
    fault_models: Tuple[str, ...] = ("bitflip", "random_value")
    bands: Tuple[str, ...] = ("all", "low", "significant", "sign")
    analytic_bound: Callable[[CellPlan], Optional[float]] = lambda p: None
    overhead: Optional[Callable[[Any, CellPlan],
                                Tuple[Callable, Callable]]] = None
    overhead_phases: Optional[Callable[[Any, CellPlan], dict]] = None
    #: False for targets whose trial injects into a single element —
    #: expand() skips flips_per_trial > 1 plans for them
    multi_flip: bool = True
    #: True for targets with a tunable detection threshold (the EB
    #: rel_bound) — expand() sweeps spec.rel_bounds over them only
    thresholded: bool = False
    #: the JAX target's grid metadata: a victim addressable by leaf-path
    #: pattern, a multi-step soak, a data-shard mesh
    victim_selectable: bool = False
    shardable: bool = False

    def __post_init__(self):
        if not all((self.build, self.draw, self.trial)):
            raise ValueError(f"target {self.name!r}: build, draw and trial "
                             f"are required")

    @property
    def soakable(self) -> bool:
        """A multi-step soak (``steps``, ``persistent`` sweeps) applies."""
        return self.soak is not None


TARGETS: dict = {}


def register_target(target: InjectableTarget) -> InjectableTarget:
    TARGETS[target.name] = target
    return target


def get_target(name: str) -> InjectableTarget:
    if name not in TARGETS:
        raise KeyError(
            f"unknown target {name!r}; registered: {sorted(TARGETS)}")
    return TARGETS[name]


def _scheme(state) -> Optional[str]:
    """The default scheme (the kernel on CUDA tensors), or the plain
    version on any device."""
    return "plain" if state["plain"] else None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# GEMM targets — paper Table II.  Serving model: B's checksum is encoded
# once from the CLEAN weights; the injected flip is a memory error the
# amortized checksum must catch (§IV-A1).
# ---------------------------------------------------------------------------

def _gemm_build(plan: CellPlan, gen: torch.Generator, *, device,
                plain: bool = False):
    m, n, k = plan.shape
    a = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    # serving memory model: checksum lanes encoded ONCE from clean weights
    packed = QGEMM.encode(b).to(device)
    return {"a": a.to(device), "packed": packed, "n": n,
            "b": packed[:, :n], "plain": plain}


def _gemm_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    if not faulty:
        return [Trial()] * n
    victim = _meta(tuple(state["b"].shape), torch.int8)
    return [Trial(draw_faults(gen, victim, plan)) for _ in range(n)]


def _packed_index(state, i: int) -> int:
    """Flat index into B [k, n] -> into B' [k, n + LANE]."""
    row, col = divmod(i, state["n"])
    return row * (state["n"] + LANE) + col


def _gemm_run(state, t: Trial, rule: ResolvedRule):
    flat = signed_view(state["packed"])
    undo, corrupted = inject_(
        flat, [f._replace(index=_packed_index(state, f.index))
               for f in t.faults], 8)
    _, check = QGEMM(state["packed"], state["a"], rule=rule)
    detected = check.err_count > 0
    restore_(undo, 8)
    return detected, corrupted


def _gemm_b_trial(state, plan: CellPlan, t: Trial):
    return _gemm_run(state, t, ResolvedRule(scheme=_scheme(state)))


def _gemm_bound(plan: CellPlan):
    m = plan.shape[0]
    if plan.fault_model == "bitflip" and plan.flips == 1 \
            and plan.bit_band == "all":
        return ag.detect_prob_b_bitflip(m)
    if plan.fault_model == "random_value":
        return ag.detect_prob_b_random(m)
    return None


def _gemm_overhead(state, plan: CellPlan, scheme: Optional[str] = None):
    rule = ResolvedRule(scheme=scheme or _scheme(state))
    a, packed = state["a"], state["packed"]

    def protected():
        return QGEMM(packed, a, rule=rule)[0]

    def unprotected():
        return QGEMM.unprotected(packed, a)

    return protected, unprotected


def _gemm_phases(state, plan: CellPlan) -> dict:
    """encode / gemm / verify — §IV's amortization story as numbers: the
    encode phase is the amortized one-time cost, gemm the baseline, and
    verify the per-call detection surcharge."""
    a, packed, n = state["a"], state["packed"], state["n"]
    c_full = ag.int_matmul(a, packed)
    c, check_col = c_full[:, :n], c_full[:, n]
    return {
        "encode": lambda: QGEMM.encode(state["b"]),
        "gemm": lambda: QGEMM.unprotected(packed, a),
        "verify": lambda: ag.verify_rows(c, check_col),
    }


register_target(InjectableTarget(
    name="gemm_packed",
    build=_gemm_build, draw=_gemm_draw, trial=_gemm_b_trial,
    default_shapes=((20, 256, 512),), shape_arity=3,
    analytic_bound=_gemm_bound, overhead=_gemm_overhead,
    overhead_phases=_gemm_phases))


_UNFUSED = ResolvedRule(scheme="unfused")


def _gemm_unfused_trial(state, plan: CellPlan, t: Trial):
    # BLAS-2 verification path (§IV-A3 step ③), amortized clean encode
    return _gemm_run(state, t, _UNFUSED)


register_target(InjectableTarget(
    name="gemm_unfused",
    build=_gemm_build, draw=_gemm_draw, trial=_gemm_unfused_trial,
    default_shapes=((20, 256, 512),), shape_arity=3,
    analytic_bound=_gemm_bound,
    overhead=functools.partial(_gemm_overhead, scheme="unfused"),
    overhead_phases=_gemm_phases))


def _gemm_pallas_phases(state, plan: CellPlan) -> dict:
    """encode / gemm / fused_gemm_verify — the kernel has no separate
    verify phase (its epilogue checks the tile it just produced), so the
    breakdown times the whole fused call; the surcharge is
    fused_gemm_verify − gemm."""
    protected, unprotected = _gemm_overhead(state, plan)
    return {
        "encode": lambda: QGEMM.encode(state["b"]),
        "gemm": unprotected,
        "fused_gemm_verify": protected,
    }


register_target(InjectableTarget(
    name="gemm_pallas",
    build=_gemm_build, draw=_gemm_draw, trial=_gemm_b_trial,
    default_shapes=((20, 256, 512),), shape_arity=3,
    analytic_bound=_gemm_bound, overhead=_gemm_overhead,
    overhead_phases=_gemm_pallas_phases))


def _gemm_c_build(plan: CellPlan, gen: torch.Generator, *, device,
                  plain: bool = False):
    """The clean int32 C and its checksum column, once per cell; trials
    corrupt C (the accumulator-resident intermediate, §IV-C2)."""
    st = _gemm_build(plan, gen, device=device)
    n = st["n"]
    c_full = ag.int_matmul(st["a"], st["packed"][:, :n + 1])
    return {"c": c_full[:, :n].contiguous(),
            "check_col": c_full[:, n].contiguous()}


def _gemm_c_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    if not faulty:
        return [Trial()] * n
    return [Trial(draw_faults(gen, state["c"], plan)) for _ in range(n)]


def _gemm_c_trial(state, plan: CellPlan, t: Trial):
    flat = signed_view(state["c"])
    undo, corrupted = inject_(flat, t.faults, 32)
    _, err = ag.verify_rows(state["c"], state["check_col"])
    detected = err > 0
    restore_(undo, 32)
    return detected, corrupted


def _gemm_c_bound(plan: CellPlan):
    if plan.fault_model == "bitflip":
        return 1.0          # 2^k mod 127 != 0 for every k: always caught
    return ag.detect_prob_c_random()


register_target(InjectableTarget(
    name="gemm_c",
    build=_gemm_c_build, draw=_gemm_c_draw, trial=_gemm_c_trial,
    default_shapes=((20, 256, 512),), shape_arity=3,
    dtypes=("int32",), analytic_bound=_gemm_c_bound))


# ---------------------------------------------------------------------------
# EmbeddingBag targets — paper Table III.  The flip strikes a random element
# among the rows a bag accesses (an untouched-row flip is invisible by
# construction).  α ~ U(0.01, 0.02), β ~ U(0.3, 0.7): the trained-table
# regime, where the low-bit band straddles the round-off bound as in the
# paper.
# ---------------------------------------------------------------------------

def _eb_build(plan: CellPlan, gen: torch.Generator, *, device,
              plain: bool = False):
    rows, dim, _, _ = plan.shape
    table = torch.randint(-128, 128, (rows, dim), generator=gen,
                          dtype=torch.int8)
    alphas = torch.rand((rows,), generator=gen) * 1e-2 + 1e-2
    betas = torch.rand((rows,), generator=gen) * 0.4 + 0.3
    enc = EMBEDDING_BAG.encode(tuple(x.to(device)
                                     for x in (table, alphas, betas)))
    return {"enc": enc, "plain": plain}


def _eb_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    rows, dim, bags, pool = plan.shape
    # every trial's bags in one host-to-device copy
    idx = torch.randint(0, rows, (n, bags, pool), generator=gen,
                        dtype=torch.int32)
    on_dev = idx.to(state["enc"][0].device)
    if not faulty:
        return [Trial((), on_dev[i]) for i in range(n)]
    elem = _meta((1,), torch.int8)
    out = []
    for i in range(n):
        b = int(torch.randint(0, bags, (), generator=gen))
        p = int(torch.randint(0, pool, (), generator=gen))
        col = int(torch.randint(0, dim, (), generator=gen))
        row = int(idx[i, b, p])
        faults = tuple(f._replace(index=row * dim + col)
                       for f in draw_faults(gen, elem, plan))
        out.append(Trial(faults, on_dev[i]))
    return out


def _eb_rule(state, plan: CellPlan) -> ResolvedRule:
    """The cell's Eq. (5) threshold (None = default) as a plan rule."""
    return ResolvedRule(rel_bound=plan.rel_bound, scheme=_scheme(state))


def _eb_trial(state, plan: CellPlan, t: Trial):
    enc = state["enc"]
    undo, corrupted = inject_(signed_view(enc[0]), t.faults, 8)
    _, check = EMBEDDING_BAG(enc, t.indices, rule=_eb_rule(state, plan))
    detected = check.err_count > 0
    restore_(undo, 8)
    return detected, corrupted


#: float32 round-off of the Eq. (5) sums moves a bag's |RSum - CSum| /
#: bound by up to ~2.3% at the grids' EB shapes (measured against float64):
#: a trial whose margin (:func:`eb_margins`) lies within this fraction of 0
#: may be decided either way by two correct orders of summation
EB_ROUND_OFF = 0.05


def eb_sums64(state, plan: CellPlan, trials) -> List[Tuple[torch.Tensor,
                                                            ...]]:
    """Each EmbeddingBag trial's Eq. (5) terms per bag, in float64 on the
    CPU, with the trial's faults in the table: ``(RSum, CSum, bound)``,
    each ``[bags]``."""
    table, alphas, betas, rowsums = (x.cpu() for x in state["enc"])
    table = table.clone()
    flat = signed_view(table)
    d = table.shape[-1]
    rel = EMBEDDING_BAG.default_rel_bound if plan.rel_bound is None \
        else plan.rel_bound
    out = []
    for t in trials:
        idx = t.indices.cpu().long()
        undo, _ = inject_(flat, t.faults, 8)
        rows = table[idx].double()
        restore_(undo, 8)
        a, b = alphas[idx].double(), betas[idx].double()
        ct = rowsums[idx].double()
        rsum = (a[..., None] * rows + b[..., None]).sum((-2, -1))
        csum = (a * ct + d * b).sum(-1)
        mag = (a.abs() * ct.abs() + d * b.abs()).sum(-1)
        out.append((rsum, csum, rel * mag.clamp(min=1.0)))
    return out


def eb_margins(state, plan: CellPlan, trials) -> List[float]:
    """The Eq. (5) decision margin of each EmbeddingBag trial, in float64:
    the largest ``|RSum - CSum| / bound`` over its bags, minus 1 (> 0:
    flagged).  Within :data:`EB_ROUND_OFF` of 0 the order of the sums
    decides the flag."""
    return [float(((rsum - csum).abs() / bound).max()) - 1.0
            for rsum, csum, bound in eb_sums64(state, plan, trials)]


def _eb_fixed_bags(state, plan: CellPlan) -> torch.Tensor:
    rows, _, bags, pool = plan.shape
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, rows, (bags, pool), generator=gen,
                         dtype=torch.int32).to(state["enc"][0].device)


def _eb_overhead(state, plan: CellPlan):
    idx, enc, rule = _eb_fixed_bags(state, plan), state["enc"], \
        _eb_rule(state, plan)

    def protected():
        return EMBEDDING_BAG(enc, idx, rule=rule)[0]

    def unprotected():
        return EMBEDDING_BAG.unprotected(enc, idx)

    return protected, unprotected


def _eb_phases(state, plan: CellPlan) -> dict:
    protected, unprotected = _eb_overhead(state, plan)
    return {
        "encode": lambda: EMBEDDING_BAG.encode(state["enc"][:3]),
        "lookup": unprotected,
        "lookup_verify": protected,
    }


register_target(InjectableTarget(
    name="embedding_bag",
    build=_eb_build, draw=_eb_draw, trial=_eb_trial,
    default_shapes=((10_000, 128, 10, 100),), shape_arity=4,
    overhead=_eb_overhead, overhead_phases=_eb_phases,
    multi_flip=False, thresholded=True))


# the JAX package's smaller kernel cell: the pallas grid pins BOTH EB
# targets to this shape so their cells stay directly comparable
register_target(InjectableTarget(
    name="eb_pallas",
    build=_eb_build, draw=_eb_draw, trial=_eb_trial,
    default_shapes=((2000, 64, 8, 32),), shape_arity=4,
    overhead=_eb_overhead, overhead_phases=_eb_phases,
    multi_flip=False, thresholded=True))


# ---------------------------------------------------------------------------
# KV-cache target (beyond-paper: core.abft_kvcache).  dtype selects the
# victim: int8 = the quantized cache payload (exact integer checksum),
# float32 = the α dequant scales, which the rowsum does NOT cover — a
# deliberate coverage-gap cell whose escape rate quantifies what a fault
# in the scales gets away with.
# ---------------------------------------------------------------------------

def _kv_build(plan: CellPlan, gen: torch.Generator, *, device,
              plain: bool = False):
    b, heads, s, dh = plan.shape
    x = torch.randn((b, heads, s, dh), generator=gen).to(device)
    return {"kv": KV_CACHE.encode(x), "x": x}


def _kv_victim(state, plan: CellPlan) -> torch.Tensor:
    kv = state["kv"]
    return kv.alpha if plan.dtype == "float32" else kv.q


def _kv_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    if not faulty:
        return [Trial()] * n
    v = _kv_victim(state, plan)
    victim = _meta(tuple(v.shape), v.dtype)
    return [Trial(draw_faults(gen, victim, plan)) for _ in range(n)]


def _kv_trial(state, plan: CellPlan, t: Trial):
    v = _kv_victim(state, plan)
    nbits = v.element_size() * 8
    undo, corrupted = inject_(signed_view(v), t.faults, nbits)
    _, err = verify_kv(state["kv"])
    detected = err > 0
    restore_(undo, nbits)
    return detected, corrupted


def _kv_bound(plan: CellPlan):
    if plan.dtype == "int8" and plan.fault_model == "bitflip":
        return 1.0          # exact integer rowsum: any payload flip caught
    if plan.dtype == "float32":
        return 0.0          # scales are outside the checksum: by design
    return None


def _kv_overhead(state, plan: CellPlan):
    q = state["kv"]

    def protected():
        _, err = verify_kv(q)
        return KV_CACHE.dequantize(q), err

    def unprotected():
        return KV_CACHE.dequantize(q)

    return protected, unprotected


def _kv_phases(state, plan: CellPlan) -> dict:
    q = state["kv"]
    return {
        "quantize": lambda: KV_CACHE.encode(state["x"]),
        "verify": lambda: verify_kv(q),
        "dequantize": lambda: KV_CACHE.dequantize(q),
    }


register_target(InjectableTarget(
    name="kv_cache",
    build=_kv_build, draw=_kv_draw, trial=_kv_trial,
    default_shapes=((2, 2, 128, 64),), shape_arity=4,
    dtypes=("int8", "float32"),
    bands=("all", "low", "significant", "sign", "exponent", "mantissa",
           "high_mantissa"),
    analytic_bound=_kv_bound, overhead=_kv_overhead,
    overhead_phases=_kv_phases))


# ---------------------------------------------------------------------------
# Full-model decode soak (launch.steps + the reduced Llama-3.2-1B).  One
# faulty trial = flip bits in a weight leaf, run ``plan.steps`` consecutive
# decode steps (the fault struck at step 0; left in place every step when
# ``plan.persistent``), read each step's ABFT counters.  ``corrupted`` is
# the OBSERVABLE output change (a greedy token differs from the clean twin
# sequence), so the cell separates detected / masked / SDC escape.
# ---------------------------------------------------------------------------

DECODE_ARCH = "llama3.2-1b"


def _decode_build(plan: CellPlan, gen: torch.Generator, *, device,
                  plain: bool = False):
    """The reduced LM, prefilled on a seeded prompt batch.  The weights
    are made on the CPU from a seed drawn from ``gen`` (so one cell seed
    gives the same model on the CPU and the card) and moved to the device.
    The model has no switch to its ops' plain versions: they run where
    the operands lie on the CPU, so the cell's plain run is its CPU run,
    and ``plain`` on a CUDA device raises."""
    import numpy as np

    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device
    from repro_torch.core.inject import leaf_paths, victim_leaf_index
    from repro_torch.protect import default_plan, unprotected_plan

    dev = torch.device(device)
    if plain and dev.type != "cpu":
        raise ValueError(f"{plan.target}: the plain run is the CPU run; "
                         f"run the cell with device='cpu'")
    batch, prompt_len = plan.shape
    cfg = reduce_cfg(get_arch(DECODE_ARCH))
    cache_len = prompt_len + cfg.meta_tokens + 8
    model = build_model(cfg)
    ctx = Ctx(quant=True, plan=default_plan(), compute_dtype=torch.bfloat16)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    params = to_device(model.init(seed, quant=True, device="cpu"), dev)

    rng = np.random.default_rng(plan.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    tok, cache, _ = make_prefill_step(model, ctx, cache_len)(
        params, {"tokens": tokens})
    pos = torch.full((batch,), prompt_len + cfg.meta_tokens,
                     dtype=torch.int32, device=dev)
    decode = make_decode_step(model, ctx)

    # the clean twin: plan.steps greedy decode steps from the prefill
    # state — the soak's per-step SDC ground truth (deterministic decode)
    clean, c_cache, c_tok, c_pos = [], cache, tok, pos
    for _ in range(plan.steps):
        c_tok, c_cache, _ = decode(params, c_cache, c_tok, c_pos)
        c_pos = c_pos + 1
        clean.append(c_tok)

    # victim: addressed by the plan's leaf-path pattern (``attn.wq``,
    # ``mlp.down``, ``embed.table``, ...); None = the largest int8 leaf
    idx, path = victim_leaf_index(params, plan.victim)
    state = {"params": params, "victim": leaf_paths(params)[idx][1],
             "victim_path": path, "cache": cache, "tok": tok, "pos": pos,
             "decode": decode, "clean_toks": torch.stack(clean)}
    if plan.measure_overhead:
        state["decode_off"] = make_decode_step(model, Ctx(
            quant=True, plan=unprotected_plan(),
            compute_dtype=torch.bfloat16))
    return state


def _decode_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    if not faulty:
        return [Trial()] * n
    v = state["victim"]
    victim = _meta(tuple(v.shape), v.dtype)
    return [Trial(draw_faults(gen, victim, plan, state["victim_path"]))
            for _ in range(n)]


def _step_errors(metrics) -> torch.Tensor:
    return (metrics["abft/qgemm_errors"]
            + metrics["abft/embedding_bag_errors"]
            + metrics["abft/kv_cache_errors"])


def _decode_soak(state, plan: CellPlan, t: Trial) -> dict:
    """One faulty trial: the flip in place for step 0 (every step when
    ``plan.persistent``), the leaf restored bit for bit after it."""
    v = state["victim"]
    nbits = v.element_size() * 8
    cache, tok, pos = state["cache"], state["tok"], state["pos"]
    undo, _ = inject_(signed_view(v), t.faults, nbits)
    det, toks = [], []
    try:
        for step in range(plan.steps):
            if step == 1 and not plan.persistent:
                restore_(undo, nbits)
                undo = []
            tok, cache, metrics = state["decode"](state["params"], cache,
                                                  tok, pos)
            pos = pos + 1
            det.append(_step_errors(metrics) > 0)
            toks.append(tok)
    finally:
        restore_(undo, nbits)
    mismatch = torch.stack(toks) != state["clean_toks"]
    return {"detected_steps": torch.stack(det),
            "corrupted": mismatch.any(),
            "divergence": mismatch.to(torch.float32).mean()}


def _decode_trial(state, plan: CellPlan, t: Trial):
    """A clean trial: one decode step, flagged or not.  The executor
    sends the faulty trials to :func:`_decode_soak`."""
    assert not t.faults, "decode_step runs its faulty trials as soaks"
    _, _, metrics = state["decode"](state["params"], state["cache"],
                                    state["tok"], state["pos"])
    return _step_errors(metrics) > 0, False


def _decode_overhead(state, plan: CellPlan):
    if "decode_off" not in state:
        return None
    args = (state["params"], state["cache"], state["tok"], state["pos"])

    def protected():
        return state["decode"](*args)[0]

    def unprotected():
        return state["decode_off"](*args)[0]

    return protected, unprotected


register_target(InjectableTarget(
    name="decode_step",
    build=_decode_build, draw=_decode_draw, trial=_decode_trial,
    soak=_decode_soak, default_shapes=((2, 16),), shape_arity=2,
    overhead=_decode_overhead, victim_selectable=True))


__all__ = ["Fault", "Trial", "InjectableTarget", "TARGETS",
           "register_target", "get_target", "draw_faults", "inject_",
           "restore_", "EB_ROUND_OFF", "eb_sums64", "eb_margins",
           "DECODE_ARCH"]
