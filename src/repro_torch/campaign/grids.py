"""Named campaign grids of the main path (the JAX package's
``campaign/grids.py``: the same specs, so the same cell ids and seeds).

``quick``  — the smoke grid: every main-path target class, sample counts
             sized so the GEMM bit-flip cell is statistically comparable
             (±2%) to the §IV-C analytic bound, plus the int8 KV cache
             and one reduced-Llama decode cell.
``paper``  — the paper's Tables II + III campaigns at full shape coverage.
``thresholds`` — EB rel_bound sweep: detection-vs-FP tradeoff per bit band.
``pallas`` — kernel parity: the identical bit-flip grid through the kernel
             targets and the reference schemes, gated on overlapping
             detection intervals, with the overhead columns.
``soak``   — the full-model decode sweep plus a multi-step decode soak.
``victims`` — which weight leaf of the reduced LM the decode soak flips.
``training`` — training-step resilience: faults at every seam of the
             compressed-gradient pipeline, single step and a multi-step
             soak (:mod:`repro_torch.campaign.targets_training`).
``multidevice`` — the training soaks over a data mesh of ranks, so the
             checked all-reduce verifies a real collective.
``full``   — ``paper``, the KV-cache sweep, ``soak``, ``training`` and
             ``multidevice``.
"""
from __future__ import annotations

from typing import List

from repro_torch.campaign.spec import CampaignSpec, DLRM_GEMM_SHAPES


def quick_specs(seed: int = 0, samples: int = 600) -> List[CampaignSpec]:
    return [
        CampaignSpec(
            name="quick-gemm",
            targets=("gemm_packed", "gemm_c"),
            fault_models=("bitflip", "random_value"),
            bit_bands=("all",),
            shapes=((1, 256, 512), (20, 256, 512)),
            dtypes=("int8", "int32"),
            samples=max(samples, 500), seed=seed,
            measure_overhead=True),
        CampaignSpec(
            name="quick-eb",
            targets=("embedding_bag",),
            fault_models=("bitflip",),
            bit_bands=("significant", "low"),
            samples=500, seed=seed, measure_overhead=True),
        CampaignSpec(
            name="quick-kv",
            targets=("kv_cache",),
            fault_models=("bitflip",),
            bit_bands=("all",),
            dtypes=("int8", "float32"),
            samples=200, seed=seed),
        CampaignSpec(
            name="quick-soak",
            targets=("decode_step",),
            fault_models=("bitflip",),
            bit_bands=("significant",),
            samples=8, clean_samples=4, seed=seed),
    ]


def paper_specs(seed: int = 0, quick: bool = False) -> List[CampaignSpec]:
    """Tables II (GEMM, 28 DLRM shapes × B/C errors × clean) and III
    (EmbeddingBag high/low bands + clean)."""
    shapes = tuple(DLRM_GEMM_SHAPES[::4] if quick else DLRM_GEMM_SHAPES)
    return [
        CampaignSpec(
            name="paper-gemm",
            targets=("gemm_packed", "gemm_c"),
            fault_models=("bitflip",),
            bit_bands=("all",),
            shapes=shapes,
            dtypes=("int8", "int32"),
            samples=100, seed=seed),
        CampaignSpec(
            name="paper-eb",
            targets=("embedding_bag",),
            fault_models=("bitflip",),
            bit_bands=("significant", "low"),
            samples=200, clean_samples=400, seed=seed),
    ]


def thresholds_specs(seed: int = 0,
                     samples: int = 400) -> List[CampaignSpec]:
    """EB ``rel_bound`` sweep: the detection-vs-false-positive tradeoff
    curve per bit band.  Tight bounds catch low-bit flips but flag
    round-off on clean bags; the paper's 1e-5 sits between.  Clean samples
    run at every bound so the FP side of the curve is measured, not
    assumed."""
    return [CampaignSpec(
        name="eb-thresholds",
        targets=("embedding_bag",),
        fault_models=("bitflip",),
        bit_bands=("significant", "low", "sign"),
        rel_bounds=(1e-7, 1e-6, 1e-5, 1e-4, 1e-3),
        samples=samples, clean_samples=samples, seed=seed)]


def pallas_specs(seed: int = 0, quick: bool = False,
                 samples: int = 0) -> List[CampaignSpec]:
    """Kernel detection parity: the SAME bit-flip grid through the kernel
    targets and the reference schemes.  Cell seeds derive from cell ids
    (which include the target name), so the cells draw *different* fault
    samples — the parity gate is statistical: overlapping 95% Wilson
    intervals on the same grid point.  The EB cells run both targets at
    the kernel target's shape so the cells stay comparable."""
    n = samples or (400 if quick else 800)
    gemm = CampaignSpec(
        name="pallas-gemm",
        targets=("gemm_pallas", "gemm_packed", "gemm_unfused"),
        fault_models=("bitflip",),
        bit_bands=("all",),
        shapes=((20, 256, 512),),
        samples=n, clean_samples=max(64, n // 4), seed=seed,
        measure_overhead=True)
    eb = CampaignSpec(
        name="pallas-eb",
        targets=("eb_pallas", "embedding_bag"),
        fault_models=("bitflip",),
        bit_bands=("significant", "low"),
        shapes=((2000, 64, 8, 32),),
        samples=n, clean_samples=max(64, n // 4), seed=seed,
        measure_overhead=True)
    return [gemm, eb]


#: leaf-path patterns the victims grid sweeps (the protect-plan
#: vocabulary)
VICTIM_PATTERNS = ("attn.wq", "attn.wk", "attn.wo", "mlp.up", "mlp.down",
                   "embed.table", "lm_head")


def victims_specs(seed: int = 0, samples: int = 12) -> List[CampaignSpec]:
    """Per-layer victim selection in the decode soak: sweep which leaf of
    the reduced LM gets flipped and compare end-to-end detection/escape
    per victim — attention projections vs MLP vs the embedding table (an
    untouched-row table flip is invisible by construction)."""
    return [CampaignSpec(
        name="decode-victims",
        targets=("decode_step",),
        fault_models=("bitflip",),
        bit_bands=("significant",),
        victims=VICTIM_PATTERNS,
        samples=samples, clean_samples=4, seed=seed)]


def soak_specs(seed: int = 0) -> List[CampaignSpec]:
    """Full-model decode sweep plus a multi-step decode soak: one upset
    held across ``steps`` consecutive decode steps — transient (strike
    once) vs persistent (the flipped weight left in place) — with the
    per-step detection-latency histogram in the soak columns.  The
    single-step spec keeps ``steps=1`` and so the quick grid's cell ids
    and seeds."""
    single = CampaignSpec(
        name="soak",
        targets=("decode_step",),
        fault_models=("bitflip", "random_value"),
        bit_bands=("all", "significant", "low"),
        samples=16, clean_samples=8, seed=seed,
        measure_overhead=True)
    multi = CampaignSpec(
        name="decode-soak",
        targets=("decode_step",),
        fault_models=("bitflip",),
        bit_bands=("significant",),
        samples=8, clean_samples=2, seed=seed,
        steps=4, persistent=(False, True))
    return [single, multi]


#: every single-device training-pipeline seam
TRAINING_TARGETS = ("train_grad_pre", "train_payload", "train_grad_post",
                    "train_moments")


def training_specs(seed: int = 0, quick: bool = False,
                   samples: int = 0) -> List[CampaignSpec]:
    """Training-step resilience: real optimizer steps with faults at every
    seam of the compressed-gradient pipeline, plus a multi-step soak that
    tracks one upset across consecutive steps until detected, masked or
    escaped.

    Two specs: single-step coverage of the four seams, then the
    ``steps``-deep soak over the stateful seams (payload transport, error
    feedback, moments) with a transient-vs-persistent sweep, whose
    per-step detection-latency histogram lands in the soak columns."""
    n = samples or (6 if quick else 20)
    soak_steps = 4 if quick else 8
    single = CampaignSpec(
        name="train-seams",
        targets=TRAINING_TARGETS,
        fault_models=("bitflip",),
        bit_bands=("significant",) if quick else ("significant", "low"),
        dtypes=("int8", "float32"),
        samples=n, clean_samples=2, seed=seed,
        measure_overhead=True)
    soak = CampaignSpec(
        name="train-soak",
        targets=("train_payload", "train_moments"),
        fault_models=("bitflip",),
        bit_bands=("significant",),
        dtypes=("int8", "float32"),
        samples=max(4, n // 2), clean_samples=2, seed=seed,
        steps=soak_steps, persistent=(False, True))
    return [single, soak]


#: the mesh seams (repro_torch.campaign.targets_training): one rank's
#: payload in transit and the summed payload after the reduction
MULTIDEVICE_TARGETS = ("train_payload_shard", "train_reduced")


def multidevice_specs(seed: int = 0, quick: bool = False,
                      samples: int = 0,
                      shards: int = 4) -> List[CampaignSpec]:
    """Mesh-sharded campaign execution: the training soaks run over a
    data mesh of ``shards`` ranks, so ``checked_psum`` verifies a real
    collective at every step instead of the one-device path every other
    grid takes.

    Two specs: the mesh seams at the full shard count (a one-rank int8
    payload flip only the additivity check after the all-reduce can see,
    and the summed payload after verification, the post-reduction
    escape window), then ``train_payload`` over ``mesh=(1, shards)``, the
    same seam with and without a real reduction in the loop.

    The CLI launches 4 ranks for this grid when ``--device-count`` is
    absent; a smaller world runs each cell on what it has, with a
    warning and ``collective_verified`` False."""
    n = samples or (4 if quick else 12)
    soak_steps = 2 if quick else 4
    seams = CampaignSpec(
        name="multidevice-seams",
        targets=MULTIDEVICE_TARGETS,
        fault_models=("bitflip",),
        bit_bands=("significant",),
        dtypes=("int8", "int32"),
        samples=n, clean_samples=2, seed=seed,
        steps=soak_steps, mesh=(shards,))
    contrast = CampaignSpec(
        name="multidevice-contrast",
        targets=("train_payload",),
        fault_models=("bitflip",),
        bit_bands=("significant",),
        dtypes=("int8",),
        samples=n, clean_samples=2, seed=seed,
        steps=soak_steps, mesh=(1, shards))
    return [seams, contrast]


def full_specs(seed: int = 0) -> List[CampaignSpec]:
    kv = CampaignSpec(
        name="kv-sweep",
        targets=("kv_cache",),
        fault_models=("bitflip", "random_value"),
        bit_bands=("all", "low", "significant", "exponent"),
        dtypes=("int8", "float32"),
        samples=400, seed=seed, measure_overhead=True)
    return paper_specs(seed) + [kv] + soak_specs(seed) \
        + training_specs(seed) + multidevice_specs(seed)


#: the grids whose cells shard over a data mesh (the CLI launches ranks)
SHARDED_GRIDS = ("multidevice", "full")

#: the grids the port runs, by CLI name
GRIDS = {"quick": quick_specs, "paper": paper_specs,
         "thresholds": thresholds_specs, "pallas": pallas_specs,
         "soak": soak_specs, "victims": victims_specs,
         "training": training_specs, "multidevice": multidevice_specs,
         "full": full_specs}

__all__ = ["quick_specs", "paper_specs", "thresholds_specs", "pallas_specs",
           "soak_specs", "victims_specs", "training_specs",
           "multidevice_specs", "full_specs", "TRAINING_TARGETS",
           "MULTIDEVICE_TARGETS", "VICTIM_PATTERNS", "SHARDED_GRIDS",
           "GRIDS"]
