"""The JAX package's dry-run records, for the port's dry-run tests.

At jax 0.9.0 ``jax.make_mesh`` makes ``Explicit`` axes, and every
``with_sharding_constraint`` of the JAX layers then refuses the mesh
("can only refer to Auto axes", ROADMAP §C18).  The records here come
from the unchanged ``repro.launch.dryrun.run_cell`` in a subprocess whose
``jax.make_mesh`` passes ``axis_types=(Auto,) * n`` (the axes
``make_production_mesh``'s own fallback, ``Mesh(devices, axes)``,
builds); nothing under ``src/repro`` is edited.  No JAX import here: the
subprocess forces its 512 host devices before JAX starts.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap

#: the per-device flops of a train or prefill cell against JAX's
FLOPS_TOL = 0.10

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from jax.sharding import AxisType
    _make_mesh = jax.make_mesh

    def make_mesh(shape, axes, *a, **kw):
        kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
        return _make_mesh(shape, axes, *a, **kw)

    jax.make_mesh = make_mesh
    from repro.launch import dryrun
    cells, out = json.loads(sys.argv[1]), sys.argv[2]
    recs = [dryrun.run_cell(a, s, m, out) for a, s, m in cells]
    with open(os.path.join(out, "records.json"), "w") as f:
        json.dump(recs, f, default=float)
""")


def jax_records(cells, timeout: float = 600) -> list:
    """``repro.launch.dryrun.run_cell`` of each ``(arch, shape,
    multi_pod)`` on Auto mesh axes, in one subprocess; -> the records."""
    with tempfile.TemporaryDirectory(prefix="jax_dryrun_") as d:
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "JAX_PLATFORMS": "cpu"}
        r = subprocess.run(
            [sys.executable, "-c", _CODE, json.dumps(cells), d],
            capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=timeout)
        path = os.path.join(d, "records.json")
        if r.returncode or not os.path.exists(path):
            raise RuntimeError(f"the JAX dry run failed: {r.stderr[-3000:]}")
        with open(path) as f:
            return json.load(f)


def check_against_jax(rec, ref, record_property) -> float:
    """Hold a port record to JAX's: JAX's record keys, the parameter
    counts, MODEL_FLOPS and the argument bytes exactly; -> the flops
    ratio (the bytes, link bytes and peak ratios are recorded)."""
    assert rec["status"] == "ok", rec.get("traceback")
    assert ref["status"] == "ok", ref.get("error")
    missing = set(ref) - set(rec)
    assert not missing, missing
    assert rec["params"] == ref["params"]
    assert rec["model_flops_global"] == ref["model_flops_global"]
    assert (rec["memory_per_device"]["argument_bytes"]
            == ref["memory_per_device"]["argument_bytes"])
    assert rec["kernels"] == "plain" and rec["n_devices"] == 256
    ratio = rec["cost_per_device"]["flops"] / ref["cost_per_device"]["flops"]
    record_property("flops_over_jax", ratio)
    for k in ("bytes", "collective_link_bytes"):
        record_property(f"{k}_over_jax", rec["cost_per_device"][k]
                        / max(ref["cost_per_device"][k], 1.0))
    record_property("peak_over_jax",
                    rec["memory_per_device"]["peak_estimate_bytes"]
                    / ref["memory_per_device"]["peak_estimate_bytes"])
    return ratio
