"""Named campaign grids of the main path (the JAX package's
``campaign/grids.py``: the same specs, so the same cell ids and seeds).

``quick``  — the smoke grid: every main-path target class, sample counts
             sized so the GEMM bit-flip cell is statistically comparable
             (±2%) to the §IV-C analytic bound.  Its ``kv_cache`` and
             ``decode_step`` specs stay in the grid; their cells are
             skipped until ROADMAP A4 ports the targets.
``paper``  — the paper's Tables II + III campaigns at full shape coverage.
``thresholds`` — EB rel_bound sweep: detection-vs-FP tradeoff per bit band.
``pallas`` — kernel parity: the identical bit-flip grid through the kernel
             targets and the reference schemes, gated on overlapping
             detection intervals, with the overhead columns.
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


#: the JAX package's other grids and the ROADMAP items that port them
NOT_PORTED = {
    "soak": "A4 (LM decode and serving)",
    "victims": "A4 (LM decode and serving)",
    "serving_soak": "A4 (LM decode and serving)",
    "paging": "A4 (the paged KV cache)",
    "adaptive": "A5 (adaptive thresholds)",
    "training": "A6 (training under faults)",
    "multidevice": "A6 (training under faults)",
    "full": "A4-A6",
}


#: the grids the port runs, by CLI name
GRIDS = {"quick": quick_specs, "paper": paper_specs,
         "thresholds": thresholds_specs, "pallas": pallas_specs}

__all__ = ["quick_specs", "paper_specs", "thresholds_specs", "pallas_specs",
           "GRIDS", "NOT_PORTED"]
