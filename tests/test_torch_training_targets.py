"""The port's training campaign targets and ``--grid training``
(``repro_torch.campaign.targets_training``) against the JAX package's
unchanged targets (jax 0.9.0 here), on the CPU.

* Each single-device seam's cell, trial for trial: the port's cell draws
  JAX's own stream (``campaign/prng.py``), so each trial flips the
  element and bit the JAX trial flips (checked against JAX's own
  ``apply_fault``), and with the JAX cell's weights handed in, every
  trial's per-step detections and its exact-mismatch ``corrupted`` flag
  equal JAX's; its parameter divergence agrees within 1e-3 of itself,
  its loss divergence (a difference of two float32 losses through bf16
  attention) within 1e-3 (JAX jits its soak; the port runs eagerly).
* The quick grid on the port's own weights: Wilson overlap of detection
  and FP with ``benchmarks/baselines/BENCH_campaign_training_quick.json``
  and with the JAX CLI's jax 0.9.0 artifact (committed under
  ``src/repro_torch/campaign/baselines/``), 0 differ regressions
  against both, and JAX CI's seam semantics: the int8 payload detects
  every flip at latency 0, the post-verify gradient none, with nonzero
  divergence.
* The mesh seams refuse, naming ROADMAP A8.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.campaign.targets_training  # noqa: E402,F401
from repro.campaign import grids as jgrids  # noqa: E402
from repro.campaign import spec as jspec  # noqa: E402
from repro.campaign.targets import apply_fault  # noqa: E402
from repro.campaign.targets import get_target as j_target  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import grids as tgrids  # noqa: E402
from repro_torch.campaign import spec as tspec  # noqa: E402
from repro_torch.campaign import targets_training as tt  # noqa: E402
from repro_torch.campaign.diff import diff_artifacts, wilson_gate  # noqa
from repro_torch.campaign.targets import get_target  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "baselines" / \
    "BENCH_campaign_training_quick.json"
JAX_NOW = ROOT / "src" / "repro_torch" / "campaign" / "baselines" / \
    "BENCH_campaign_training_quick.json"

SEAM_CELLS = [
    "train_grad_pre/bitflip/significant/2x16/float32",
    "train_payload/bitflip/significant/2x16/int8",
    "train_payload/bitflip/significant/2x16/float32",
    "train_grad_post/bitflip/significant/2x16/float32",
    "train_moments/bitflip/significant/2x16/float32",
]


def _plans(grids, spec_mod):
    return {p.cell_id: p for s in grids.training_specs(0, quick=True)
            for p in spec_mod.expand(s)[0]}


def test_quick_grid_expands_to_jax_cells():
    jp, tp = _plans(jgrids, jspec), _plans(tgrids, tspec)
    assert list(jp) == list(tp)
    for cid in jp:
        assert jp[cid].seed == tp[cid].seed
        assert (jp[cid].steps, jp[cid].persistent, jp[cid].samples,
                jp[cid].clean_samples) == (tp[cid].steps,
                                           tp[cid].persistent,
                                           tp[cid].samples,
                                           tp[cid].clean_samples)


def _flip_coords(before: np.ndarray, after: np.ndarray):
    """(flat index, bit) of the one bit ``after`` flipped in ``before``."""
    width = {1: np.uint8, 4: np.uint32}[before.dtype.itemsize]
    diff = (before.reshape(-1).view(width)
            ^ after.reshape(-1).view(width))
    (idx,) = np.nonzero(diff)
    assert len(idx) == 1
    return int(idx[0]), int(diff[idx[0]]).bit_length() - 1


@pytest.mark.parametrize("cell_id", SEAM_CELLS)
def test_seam_cell_trial_for_trial_against_jax(cell_id):
    jplan = _plans(jgrids, jspec)[cell_id]
    tplan = _plans(tgrids, tspec)[cell_id]
    jtarget = j_target(jplan.target)
    k_build, k_trial, _ = jax.random.split(jax.random.key(jplan.seed), 3)
    jstate = jtarget.build(jplan, k_build, mesh=None)
    keys = jax.random.split(k_trial, jplan.samples)
    jout = jax.device_get(jax.jit(jax.vmap(
        lambda k: jtarget.soak(jstate, jplan, k)))(keys))

    target = get_target(tplan.target)
    params = from_jax(jax.tree.map(np.asarray, jstate["params"]),
                      device="cpu")
    state = target.build(tplan, None, device="cpu", params=params)
    trials = target.draw(state, tplan, None, tplan.samples, True)
    assert state["victim_path"] == jstate["victim_path"]
    assert state["victim_idx"] == jstate["victim_idx"]

    # the same element and bit as JAX's own apply_fault on the seam's leaf
    dtype = jnp.int8 if tplan.dtype == "int8" else jnp.float32
    leaf = jnp.zeros(jax.tree.leaves(jstate["params"])[
        jstate["victim_idx"]].shape, dtype)
    for k, t in zip(keys, trials):
        flipped = np.asarray(apply_fault(k, leaf, jplan))
        assert [(f.index, f.bit) for f in t.faults] == \
            [_flip_coords(np.asarray(leaf), flipped)]

    outs = [target.soak(state, tplan, t) for t in trials]
    np.testing.assert_array_equal(
        np.stack([o["detected_steps"].numpy() for o in outs]),
        np.asarray(jout["detected_steps"]))
    np.testing.assert_array_equal(
        np.array([bool(o["corrupted"]) for o in outs]),
        np.asarray(jout["corrupted"]))
    np.testing.assert_allclose(
        np.array([float(o["divergence"]) for o in outs]),
        np.asarray(jout["divergence"]), rtol=1e-3, atol=1e-8)
    # a loss moved by a fault is a difference of two ~6.0 float32 losses
    # through bf16 attention: the packages' losses of the same corrupted
    # weights part by up to ~1e-3 (measured 5.3e-4)
    np.testing.assert_allclose(
        np.array([float(o["loss_divergence"]) for o in outs]),
        np.asarray(jout["loss_divergence"]), rtol=0.1, atol=1e-3)
    # the clean twin flags nothing (its trials are the FP side)
    assert not bool(target.trial(state, tplan, tt.Trial())[0])


@pytest.fixture(scope="module")
def quick_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    assert cli.main(["--grid", "training", "--quick", "--device", "cpu",
                     "--out", str(out)]) == 0
    return json.loads((out / "BENCH_campaign_training_quick.json")
                      .read_text())


def _masked_only(regressions, artifact) -> bool:
    """Every regression is a detection-rate drop of a bound-0 seam, where
    the rate is the masked share (no check can fire there)."""
    cells = {c["cell_id"]: c["metrics"] for c in artifact["cells"]}
    return all(r["kind"] == "detection_rate"
               and cells[r["cell_id"]]["analytic_bound"] == 0.0
               and cells[r["cell_id"]]["detected"] == 0
               for r in regressions)


@pytest.mark.parametrize("ref", [BASELINE, JAX_NOW], ids=["baseline",
                                                          "jax_now"])
def test_quick_grid_gated_against_jax(quick_artifact, ref):
    """Wilson overlap in every cell.  The differ's 2-point tolerance is
    below one trial of these 4-6 trial cells, and a bound-0 seam's
    masked share is decided at float32 rounding (ROADMAP §C11): the
    unchanged JAX package at jax 0.9.0 regresses against its own
    baseline so.  The differ holds every FP rate and the coverage, and
    may flag only masked shares, each inside the Wilson overlap."""
    ref = json.loads(ref.read_text())
    gate = wilson_gate(ref, quick_artifact)
    assert gate["failed"] == [] and gate["uncovered"] == []
    assert len(gate["cells"]) == 11
    diff = diff_artifacts(ref, quick_artifact)
    assert diff["removed"] == []
    assert _masked_only(diff["regressions"], quick_artifact)


def test_the_reference_regresses_against_its_own_baseline():
    """The JAX CLI's artifact (jax 0.9.0, unchanged package) against the
    committed baseline: a masked share moves by a trial."""
    diff = diff_artifacts(json.loads(BASELINE.read_text()),
                          json.loads(JAX_NOW.read_text()))
    assert diff["regressions"]
    assert _masked_only(diff["regressions"],
                        json.loads(JAX_NOW.read_text()))


def test_quick_grid_seam_semantics(quick_artifact):
    cells = {c["cell_id"]: c["metrics"] for c in quick_artifact["cells"]}
    assert all(m["false_positives"] == 0 for m in cells.values())
    for cid, m in cells.items():
        if cid.startswith("train_payload/") and "/int8" in cid:
            # the transport seam: every flip caught at the step it struck
            assert m["detected"] == m["samples"]
            assert m["detection_latency_hist"][0] == m["samples"]
            assert m["analytic_bound"] == 1.0
        else:
            assert m["detected"] == 0 and m["analytic_bound"] == 0.0
    post = cells["train_grad_post/bitflip/significant/2x16/float32"]
    assert post["divergence_mean"] > 0 and post["escapes"] > 0
    canon = cells["train_payload/bitflip/significant/2x16/int8"]
    assert canon["protected_s"] > 0 and canon["unprotected_s"] > 0


@pytest.mark.parametrize("name", ["train_payload_shard", "train_reduced"])
def test_mesh_seams_refused(name):
    """The mesh seams are registered (ROADMAP A8.2); at one shard a
    payload flip is the single-device seam's (caught at its step) and a
    flip of the reduced sum escapes (bound 0).  Their 4-rank cells run
    in ``tests/test_torch_campaign_multidevice.py``."""
    from repro_torch.campaign.executor import run_cell
    from repro_torch.campaign.spec import CampaignSpec, expand
    target = get_target(name)
    assert target.shardable
    dtype = "int8" if name == "train_payload_shard" else "int32"
    (plan,), _ = expand(CampaignSpec(
        name="one-shard", targets=(name,), fault_models=("bitflip",),
        bit_bands=("significant",), dtypes=(dtype,), samples=2,
        clean_samples=1, seed=0))
    m = run_cell(plan, device="cpu").metrics
    assert m.shards == 1 and m.collective_verified is False
    assert m.false_positives == 0
    if name == "train_payload_shard":
        assert m.detected == 2 and m.analytic_bound == 1.0
    else:
        assert m.detected == 0 and m.escapes == 2
        assert m.analytic_bound == 0.0


@pytest.mark.parametrize("fault_model,flips,dtype", [
    ("random_value", 1, "float32"), ("random_value", 1, "int8"),
    ("bitflip", 3, "float32"), ("bitflip", 2, "int8")])
def test_other_fault_models_draw_jax_faults(fault_model, flips, dtype):
    """Random values and multi-flip trials: each key's faults are the
    ones JAX's ``apply_fault`` strikes (distinct elements by Floyd's
    algorithm; a value's low bits)."""
    from repro.campaign.spec import CellPlan as JPlan
    from repro_torch.campaign.spec import CellPlan
    kw = dict(cell_id="x", target="train_payload", fault_model=fault_model,
              bit_band="all", shape=(2, 16), dtype=dtype, samples=4,
              clean_samples=0, flips=flips, seed=3, measure_overhead=False,
              rel_bound=None, victim=None, steps=1, persistent=False,
              data_shards=1)
    jplan, tplan = JPlan(**kw), CellPlan(**kw)
    jd = jnp.int8 if dtype == "int8" else jnp.float32
    td = torch.int8 if dtype == "int8" else torch.float32
    width = np.uint8 if dtype == "int8" else np.uint32
    leaf = np.zeros((64, 32), jd)
    for s in range(4):
        key = jax.random.fold_in(jax.random.key(0), s)
        after = np.asarray(apply_fault(key, jnp.asarray(leaf), jplan))
        faults = tt._fault_at(np.asarray(jax.random.key_data(key)),
                              leaf.size, td, tplan)
        words = after.reshape(-1).view(width)
        (changed,) = np.nonzero(words)
        if fault_model == "bitflip":
            assert sorted((f.index, f.bit) for f in faults) == sorted(
                (int(i), int(words[i]).bit_length() - 1) for i in changed)
        else:
            (f,) = faults
            nbits = 8 * leaf.itemsize
            assert int(words[f.index]) == f.value & ((1 << nbits) - 1)
            assert set(changed) <= {f.index}
