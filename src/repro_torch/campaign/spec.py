"""Declarative resilience-campaign specs (the JAX package's
``campaign/spec.py``: the same specs expand to the same cell ids and
seeds, so the two packages' artifacts compare cell by cell).

A :class:`CampaignSpec` names a grid — (injectable target × fault model ×
bit band × shape × dtype × sample count) — and :func:`expand` turns it into
concrete :class:`CellPlan` s, one per grid cell, filtering combinations a
target cannot realize (wrong shape arity, unsupported dtype/band/model)
and recording why each was skipped so sweeps never silently shrink.

Specs are plain frozen dataclasses: serializable to JSON (artifacts embed
them), hashable, and cheap to build programmatically (benchmarks build them
per paper table; users build them in examples/).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.inject import bit_band as inject_bit_band

# ---------------------------------------------------------------------------
# The paper's Fig. 5 evaluates 28 DLRM GEMM shapes (m, n, k) — "peculiar
# matrix sizes": small m (batch), large n/k (layer widths), reconstructed
# from the DLRM bottom (13-512-256-128) and top (479-1024-1024-512-256-1)
# MLPs, the paper's quoted (1, 800, 3200) point, and FBGEMM benchmark
# shapes.
# ---------------------------------------------------------------------------
DLRM_GEMM_SHAPES: List[Tuple[int, int, int]] = [
    # bottom MLP, batch 1..256
    (1, 512, 13), (1, 256, 512), (1, 128, 256),
    (20, 512, 13), (20, 256, 512), (20, 128, 256),
    (100, 512, 13), (100, 256, 512), (100, 128, 256),
    (256, 512, 13), (256, 256, 512), (256, 128, 256),
    # top MLP, batch 1..256
    (1, 1024, 479), (1, 1024, 1024), (1, 512, 1024), (1, 256, 512),
    (20, 1024, 479), (20, 1024, 1024), (20, 512, 1024),
    (100, 1024, 479), (100, 1024, 1024), (100, 512, 1024),
    (256, 1024, 479), (256, 1024, 1024),
    # wide serving projections (paper's fast case (1, 800, 3200) included)
    (1, 800, 3200), (10, 800, 3200), (64, 800, 3200), (100, 800, 3200),
]
assert len(DLRM_GEMM_SHAPES) == 28


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One declarative sweep.

    ``shapes=()`` means "each target's default shapes".  When explicit
    shapes are given they must match a target's arity (gemm: (m, n, k);
    embedding_bag: (rows, dim, bags, pool); kv_cache: (b, kv_heads, s, dh);
    decode_step: (batch, prompt_len)) — mismatches are skipped, not errors,
    so one spec can sweep heterogeneous targets with per-target shapes.
    """
    name: str
    targets: Tuple[str, ...]
    fault_models: Tuple[str, ...] = ("bitflip",)
    bit_bands: Tuple[str, ...] = ("all",)
    shapes: Tuple[Tuple[int, ...], ...] = ()
    dtypes: Tuple[str, ...] = ("int8",)
    samples: int = 100
    clean_samples: Optional[int] = None   # None -> same as samples
    flips_per_trial: int = 1
    seed: int = 0
    measure_overhead: bool = False
    #: detection-threshold sweep (thresholded targets only, e.g. the EB
    #: rel_bound): () = each target's default bound
    rel_bounds: Tuple[float, ...] = ()
    #: injection-victim sweep (victim-selectable targets only, e.g. the
    #: decode soak): leaf-path patterns in the protect-plan vocabulary
    #: (``attn.wq``, ``mlp.down``, ``embed.table``, ...); () = each
    #: target's default victim (largest int8 leaf)
    victims: Tuple[str, ...] = ()
    #: multi-step soak depth (soak-capable targets only): each trial runs
    #: ``steps`` consecutive train/decode steps and reports per-step
    #: detection so a single upset's latency is measured, not just its
    #: eventual fate.  1 = the classic single-shot trial.
    steps: int = 1
    #: fault-persistence sweep (soak-capable targets only): False = one
    #: transient upset at step 0; True = the fault re-strikes the same
    #: site every step (a failing cell re-corrupting each access).
    persistent: Tuple[bool, ...] = (False,)
    #: data-shard mesh sweep (shardable targets only): each value N > 1
    #: runs the cell's soak under ``shard_map`` over a fake ``data`` axis
    #: of N host devices, so ``checked_psum`` verifies a REAL collective
    #: (N = 1 is the single-device verify-only path).  The executor
    #: places each sharded cell on its own slice of the host mesh.
    mesh: Tuple[int, ...] = (1,)

    def __post_init__(self):
        if self.samples < 1:
            raise ValueError("samples must be >= 1")
        if self.flips_per_trial < 1:
            raise ValueError("flips_per_trial must be >= 1")
        if any(b <= 0 for b in self.rel_bounds):
            raise ValueError("rel_bounds must be positive")
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if any(s < 1 for s in self.mesh):
            raise ValueError("mesh shard counts must be >= 1")
        # tolerate lists from JSON round-trips / hand-written specs
        for f in ("targets", "fault_models", "bit_bands", "dtypes",
                  "rel_bounds", "victims", "persistent", "mesh"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        object.__setattr__(
            self, "shapes", tuple(tuple(s) for s in self.shapes))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """One fully-resolved grid cell: everything an executor needs."""
    cell_id: str
    target: str
    fault_model: str
    bit_band: str
    shape: Tuple[int, ...]
    dtype: str
    samples: int
    clean_samples: int
    flips: int
    seed: int
    measure_overhead: bool
    #: detection-threshold override (None = the target's default bound)
    rel_bound: Optional[float] = None
    #: injection-victim leaf-path pattern (None = target default)
    victim: Optional[str] = None
    #: consecutive steps per trial (soak-capable targets; 1 = single shot)
    steps: int = 1
    #: True = the fault re-strikes the same site every step of the soak
    persistent: bool = False
    #: data shards the soak runs under (shardable targets; 1 = no mesh,
    #: N > 1 = shard_map over a fake ``data`` axis of N host devices)
    data_shards: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def cell_seed(spec_seed: int, cell_id: str) -> int:
    """Stable per-cell PRNG seed: independent of cell order and of
    PYTHONHASHSEED, so artifacts reproduce cell-for-cell."""
    h = hashlib.sha256(f"{spec_seed}:{cell_id}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def _cell_id(target: str, model: str, band: str,
             shape: Sequence[int], dtype: str,
             rel_bound: Optional[float] = None,
             victim: Optional[str] = None,
             steps: int = 1, persistent: bool = False,
             data_shards: int = 1) -> str:
    s = "x".join(str(d) for d in shape) if shape else "default"
    base = f"{target}/{model}/{band}/{s}/{dtype}"
    if rel_bound is not None:
        base += f"/rb{rel_bound:g}"
    if victim is not None:
        base += f"/vic={victim}"
    if steps > 1:
        base += f"/steps{steps}"
    if persistent:
        base += "/persistent"
    if data_shards > 1:
        base += f"/shards{data_shards}"
    return base


def expand(spec: CampaignSpec) -> Tuple[List[CellPlan], List[dict]]:
    """Spec -> (plans, skipped).

    ``skipped`` entries are ``{"cell_id": ..., "reason": ...}`` — a sweep
    that silently drops cells reads as "covered everything" when it didn't.
    """
    from repro_torch.campaign.targets import get_target

    plans: List[CellPlan] = []
    skipped: List[dict] = []
    seen = set()
    bounds_or_default = spec.rel_bounds if spec.rel_bounds else (None,)
    victims_or_default = spec.victims if spec.victims else (None,)
    for tname, model, band, dtype in itertools.product(
            spec.targets, spec.fault_models, spec.bit_bands, spec.dtypes):
        target = get_target(tname)   # unknown target = hard error
        shapes = spec.shapes if spec.shapes else target.default_shapes
        bounds = bounds_or_default if target.thresholded else (None,)
        if spec.rel_bounds and not target.thresholded:
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype),
                "reason": f"target {tname} has no detection threshold "
                          f"(rel_bounds sweep ignored)"})
        victims = victims_or_default if target.victim_selectable \
            else (None,)
        if spec.victims and not target.victim_selectable:
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype),
                "reason": f"target {tname} has no selectable victim "
                          f"(victims sweep ignored)"})
        soakable = target.soakable
        steps = spec.steps if soakable else 1
        if spec.steps > 1 and not soakable:
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype),
                "reason": f"target {tname} is single-step "
                          f"(steps={spec.steps} ignored)"})
        persistence = tuple(dict.fromkeys(spec.persistent)) if soakable \
            else (False,)
        if any(spec.persistent) and not soakable:
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype),
                "reason": f"target {tname} cannot carry a persistent "
                          f"fault (persistent sweep ignored)"})
        shard_counts = tuple(dict.fromkeys(spec.mesh)) \
            if target.shardable else (1,)
        if any(s > 1 for s in spec.mesh) and not target.shardable:
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype),
                "reason": f"target {tname} cannot shard its collective "
                          f"(mesh sweep ignored)"})
        if steps == 1 and any(persistence):
            # a fault that re-strikes "every step" of a 1-step trial IS
            # the transient fault — a /persistent cell here would be a
            # duplicate measurement under a misleading label
            persistence = (False,)
            skipped.append({
                "cell_id": _cell_id(tname, model, band, (), dtype,
                                    persistent=True),
                "reason": "persistent is indistinguishable from "
                          "transient at steps=1 (duplicate cell "
                          "dropped)"})
        for shape, rel_bound, victim, persistent, shards in \
                itertools.product(shapes, bounds, victims, persistence,
                                  shard_counts):
            cid = _cell_id(tname, model, band, shape, dtype, rel_bound,
                           victim, steps, persistent, shards)
            if cid in seen:
                continue
            seen.add(cid)

            def skip(reason):
                skipped.append({"cell_id": cid, "reason": reason})

            if spec.shapes and len(shape) != target.shape_arity:
                skip(f"shape arity {len(shape)} != {target.shape_arity} "
                     f"for target {tname}")
                continue
            if dtype not in target.dtypes:
                skip(f"dtype {dtype} unsupported by {tname}")
                continue
            if model not in target.fault_models:
                skip(f"fault model {model} unsupported by {tname}")
                continue
            if model != "bitflip" and band != "all":
                # bands parameterize bit positions; only flips have them
                skip(f"bit band {band} meaningless for model {model}")
                continue
            if band not in target.bands:
                skip(f"bit band {band} unsupported by {tname}")
                continue
            if model == "bitflip":
                try:
                    inject_bit_band(dtype, band)
                except KeyError:
                    skip(f"bit band {band} undefined for dtype {dtype}")
                    continue
            if spec.flips_per_trial > 1 and not target.multi_flip:
                skip(f"target {tname} injects a single element per trial "
                     f"(flips_per_trial={spec.flips_per_trial})")
                continue
            clean = spec.samples if spec.clean_samples is None \
                else spec.clean_samples
            plans.append(CellPlan(
                cell_id=cid, target=tname, fault_model=model,
                bit_band=band, shape=tuple(shape), dtype=dtype,
                samples=spec.samples, clean_samples=clean,
                flips=spec.flips_per_trial,
                seed=cell_seed(spec.seed, cid),
                measure_overhead=spec.measure_overhead,
                rel_bound=rel_bound, victim=victim,
                steps=steps, persistent=persistent,
                data_shards=shards))
    return plans, skipped
