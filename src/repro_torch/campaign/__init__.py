"""Resilience campaigns of the main path: declarative fault-injection
sweeps through the protected int8 GEMM (K1) and EmbeddingBag (K2).

A :class:`CampaignSpec` names a grid over (target × fault model × bit band
× shape × dtype × samples); the executor runs each cell's trials on the
card (or the CPU), and artifacts land as ``BENCH_campaign_*.json`` +
markdown in the JAX package's schema, so the committed JAX baselines gate
the port cell by cell::

    python -m repro_torch.campaign --grid pallas --quick
    python -m repro_torch.campaign --diff BASELINE.json NEW.json

Library use::

    from repro_torch.campaign import CampaignSpec, run_campaign
    spec = CampaignSpec(name="my-sweep", targets=("gemm_packed",),
                        samples=1000)
    result = run_campaign("my-sweep", [spec], out_dir=".")

Importing this package registers the targets and does nothing else.
"""
from repro_torch.campaign.artifacts import (load_artifact, markdown_table,
                                            write_artifacts)
from repro_torch.campaign.diff import (diff_artifacts, format_diff,
                                       run_diff, wilson_gate)
from repro_torch.campaign.executor import (CellResult, run_campaign,
                                           run_cell, run_specs)
from repro_torch.campaign.metrics import (CellMetrics, compute_metrics,
                                          wilson_interval)
from repro_torch.campaign.spec import (CampaignSpec, CellPlan,
                                       DLRM_GEMM_SHAPES, cell_seed, expand)
from repro_torch.campaign.targets import (Fault, InjectableTarget, TARGETS,
                                          Trial, get_target,
                                          register_target)
from repro_torch.campaign import targets_training  # noqa: F401,E402

__all__ = [
    "CampaignSpec", "CellPlan", "expand", "cell_seed", "DLRM_GEMM_SHAPES",
    "InjectableTarget", "TARGETS", "register_target", "get_target",
    "Fault", "Trial",
    "CellMetrics", "compute_metrics", "wilson_interval",
    "CellResult", "run_cell", "run_specs", "run_campaign",
    "load_artifact", "write_artifacts", "markdown_table",
    "diff_artifacts", "format_diff", "run_diff", "wilson_gate",
]
