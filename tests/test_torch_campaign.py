"""The port's main-path campaign against the JAX package's ``campaign/``.

The grids must expand to the JAX cell ids and seeds, string for string,
and each main-path target must decide a given fault as the JAX target
does: the same state, the same fixed coordinates, the same (detected,
corrupted) pair.  Fault draws come from other generators, so detection
rates are compared by Wilson interval in ``test_torch_campaign_grids.py``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.campaign import grids as j_grids  # noqa: E402
from repro.campaign import spec as j_spec  # noqa: E402
from repro.campaign import targets as j_targets  # noqa: E402
from repro.core import abft_gemm as j_ag  # noqa: E402
from repro.core.inject import flip_bit as j_flip_bit  # noqa: E402
from repro.protect.ops import EMBEDDING_BAG as J_EB  # noqa: E402
from repro.protect.ops import QGEMM as J_QGEMM  # noqa: E402
from repro.protect.plan import ResolvedRule as JRule  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import grids, spec  # noqa: E402
from repro_torch.campaign.executor import (  # noqa: E402
    _generators, run_cell)
from repro_torch.campaign.targets import (  # noqa: E402
    EB_ROUND_OFF, Fault, Trial, eb_margins, get_target)
from repro_torch.core.inject import signed_view  # noqa: E402

_GRIDS = [
    ("quick", lambda g: g.quick_specs(seed=0)),
    ("quick-s7", lambda g: g.quick_specs(seed=7, samples=100)),
    ("pallas-quick", lambda g: g.pallas_specs(seed=0, quick=True)),
    ("pallas", lambda g: g.pallas_specs(seed=3)),
    ("paper-quick", lambda g: g.paper_specs(seed=0, quick=True)),
    ("paper", lambda g: g.paper_specs(seed=0)),
    ("soak", lambda g: g.soak_specs(seed=0)),
    ("victims", lambda g: g.victims_specs(seed=0, samples=4)),
]


@pytest.mark.parametrize("name,make", _GRIDS, ids=[n for n, _ in _GRIDS])
def test_expand_equals_jax(name, make):
    for t_spec, j_spec_ in zip(make(grids), make(j_grids)):
        assert t_spec.to_dict() == j_spec_.to_dict()
        t_plans, t_skipped = spec.expand(t_spec)
        j_plans, j_skipped = j_spec.expand(j_spec_)
        assert [p.to_dict() for p in t_plans] == \
            [dataclasses.asdict(p) for p in j_plans]
        assert t_skipped == j_skipped
    assert spec.cell_seed(5, "x/y") == j_spec.cell_seed(5, "x/y")
    assert spec.DLRM_GEMM_SHAPES == j_spec.DLRM_GEMM_SHAPES


def _plan(target, shape, model="bitflip", band="all", dtype="int8"):
    cid = spec._cell_id(target, model, band, shape, dtype)
    return spec.CellPlan(cell_id=cid, target=target, fault_model=model,
                         bit_band=band, shape=shape, dtype=dtype, samples=32,
                         clean_samples=0, flips=1, seed=spec.cell_seed(0, cid),
                         measure_overhead=False)


def _build(plan):
    gen = _generators(plan.seed)[0]
    return get_target(plan.target).build(plan, gen, device="cpu")


def _same(got, want):
    det, cor = got
    assert bool(det) == bool(want[0]) and bool(cor) == bool(want[1])


@pytest.mark.parametrize("target", ["gemm_packed", "gemm_unfused"])
def test_gemm_b_decisions_equal_jax(target):
    plan = _plan(target, (1, 256, 512))
    st = _build(plan)
    a = st["a"].numpy()                             # [1, k 512]
    b = st["b"].contiguous().numpy()                # [k 512, n 256]
    lanes = np.asarray(J_QGEMM.encode(jnp.asarray(b)))[:, 256:]
    rule = JRule(scheme="unfused") if target == "gemm_unfused" else JRule()
    rng = np.random.default_rng(11)
    # rows k0 whose A entry is 0 mod 127 hide any flip of B[k0, :] at m = 1
    masked = [int(k) for k in np.flatnonzero(a[0] % 127 == 0)][:4]
    idxs = [k * 256 + int(rng.integers(256)) for k in masked]
    idxs += [int(i) for i in rng.integers(0, b.size, 32 - len(idxs))]
    packed0 = st["packed"].clone()
    outcomes = set()
    for n, idx in enumerate(idxs):
        if n % 4 == 3:                         # model 2: a replaced value
            val = int(rng.integers(-128, 128))
            fault = Fault(idx, value=val)
            j_bad = jnp.asarray(b).reshape(-1).at[idx].set(val).reshape(
                b.shape)
        else:
            bit = int(rng.integers(8))
            fault = Fault(idx, bit)
            j_bad = j_flip_bit(jnp.asarray(b), jnp.int32(idx),
                               jnp.int32(bit))
        _, check = J_QGEMM(jnp.concatenate([j_bad, lanes], axis=1),
                           jnp.asarray(a), rule=rule)
        want = (int(check.err_count) > 0, bool(jnp.any(j_bad != b)))
        got = get_target(target).trial(st, plan, Trial((fault,)))
        _same(got, want)
        outcomes.add(want)
        # the trial restored B' bit for bit
        assert torch.equal(st["packed"], packed0)
    assert {(True, True), (False, True)} <= outcomes
    det, cor = get_target(target).trial(st, plan, Trial())
    assert not bool(det) and not bool(cor)


def test_gemm_c_decisions_equal_jax():
    plan = _plan("gemm_c", (20, 256, 512), dtype="int32")
    st = _build(plan)
    c, col = st["c"].numpy(), st["check_col"].numpy()
    rng = np.random.default_rng(12)
    c0 = st["c"].clone()
    outcomes = set()
    for n in range(32):
        idx = int(rng.integers(c.size))
        old = int(c.reshape(-1)[idx])
        if n % 2:
            # a replaced value; every other one off by a multiple of 127,
            # which the mod-127 row check cannot see
            val = old + 127 * int(rng.integers(1, 9)) if n % 4 == 1 \
                else int(rng.integers(-2**31, 2**31))
            fault = Fault(idx, value=val)
            j_bad = jnp.asarray(c).reshape(-1).at[idx].set(val).reshape(
                c.shape)
        else:
            bit = int(rng.integers(32))
            fault = Fault(idx, bit)
            j_bad = j_flip_bit(jnp.asarray(c), jnp.int32(idx),
                               jnp.int32(bit))
        _, err = j_ag.verify_rows(j_bad, jnp.asarray(col))
        want = (int(err) > 0, bool(jnp.any(j_bad != c)))
        _same(get_target("gemm_c").trial(st, plan, Trial((fault,))), want)
        outcomes.add(want)
        assert torch.equal(st["c"], c0)
    assert {(True, True), (False, True)} <= outcomes


@pytest.mark.parametrize("band", ["low", "significant"])
def test_embedding_bag_decisions_equal_jax(band):
    plan = _plan("embedding_bag", (2000, 64, 8, 32), band=band)
    st = _build(plan)
    table, alphas, betas, rowsums = (x.numpy() for x in st["enc"])
    j_enc = [jnp.asarray(x) for x in (table, alphas, betas, rowsums)]
    rng = np.random.default_rng(13)
    lo, hi = (0, 4) if band == "low" else (4, 8)
    t0 = st["enc"][0].clone()
    outcomes, near = set(), 0
    small_alpha = np.argsort(alphas)
    for n in range(32):
        idx = rng.integers(0, 2000, (8, 32)).astype(np.int32)
        bag, slot = rng.integers(8), rng.integers(32)
        col, bit = int(rng.integers(64)), int(rng.integers(lo, hi))
        if n % 4 == 0:
            # the lowest bit of a row with a small alpha: below the bound
            idx[bag, slot], bit = small_alpha[n], lo
        row = int(idx[bag, slot])
        j_bad = j_flip_bit(j_enc[0], jnp.int32(row * 64 + col),
                           jnp.int32(bit))
        _, check = J_EB((j_bad,) + tuple(j_enc[1:]), jnp.asarray(idx),
                        rule=JRule())
        want = (int(check.err_count) > 0,
                bool(j_bad[row, col] != j_enc[0][row, col]))
        t = Trial((Fault(row * 64 + col, bit),), torch.from_numpy(idx))
        got = get_target("embedding_bag").trial(st, plan, t)
        (margin,) = eb_margins(st, plan, [t])
        assert torch.equal(st["enc"][0], t0)
        if abs(margin) <= EB_ROUND_OFF:
            near += 1
            continue
        _same(got, want)
        assert bool(got[0]) == (margin > 0)
        outcomes.add(want)
    if band == "significant":
        assert outcomes == {(True, True)} and near == 0
    else:
        # a bit-0 flip moves a bag by about the bound itself
        assert {(True, True), (False, True)} <= outcomes and near <= 4


def test_draws_land_inside_the_victim_and_band():
    for target, shape, band, dtype in (
            ("gemm_packed", (20, 256, 512), "all", "int8"),
            ("gemm_c", (20, 256, 512), "all", "int32"),
            ("embedding_bag", (2000, 64, 8, 32), "low", "int8")):
        plan = _plan(target, shape, band=band, dtype=dtype)
        st = _build(plan)
        gen = torch.Generator().manual_seed(0)
        trials = get_target(target).draw(st, plan, gen, 64, True)
        lo, hi = {"all": (0, 8 if dtype == "int8" else 32),
                  "low": (0, 4)}[band]
        for t in trials:
            (f,) = t.faults
            assert lo <= f.bit < hi
        if target == "embedding_bag":
            # the flipped row is one the trial's bags read
            for t in trials:
                assert int(t.faults[0].index) // 64 in \
                    set(t.indices.reshape(-1).tolist())
        clean = get_target(target).draw(st, plan, gen, 4, False)
        assert all(t.faults == () for t in clean)


@pytest.mark.parametrize("target,shape,band", [
    ("gemm_packed", (20, 256, 512), "all"),
    ("embedding_bag", (2000, 64, 8, 32), "low")])
def test_run_cell_plain_decides_every_trial_as_the_default(target, shape,
                                                           band):
    # on the CPU the default scheme runs the plain versions too, so the
    # plain=True cell must repeat it trial for trial
    plan = dataclasses.replace(_plan(target, shape, band=band),
                               clean_samples=8)
    runs = [run_cell(plan, device="cpu", plain=p) for p in (False, True)]
    assert torch.equal(runs[0].trials, runs[1].trials)
    assert torch.equal(runs[0].clean, runs[1].clean)
    assert runs[0].metrics.samples == 32 and runs[0].trials[:, 1].all()


def test_value_fault_restores_and_reports_unchanged_elements():
    plan = _plan("gemm_c", (4, 16, 32), model="random_value",
                 dtype="int32")
    st = _build(plan)
    c0 = st["c"].clone()
    same = int(signed_view(st["c"])[5])
    det, cor = get_target("gemm_c").trial(st, plan,
                                          Trial((Fault(5, value=same),)))
    assert not bool(det) and not bool(cor)
    assert torch.equal(st["c"], c0)


def test_importing_the_cli_runs_nothing(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    importlib.reload(cli)
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("argv,ranks", [
    (["--grid", "multidevice", "--quick"], 4),
    (["--grid", "training", "--device-count", "4"], None),
    (["--grid", "full"], 4),
    (["--grid", "paper", "--device-count", "2"], None),
    (["--quick", "--device-count", "4"], None)])
def test_cli_refuses_unported_grids_and_flags(capsys, monkeypatch, argv,
                                              ranks):
    """The grids with sharded cells (``multidevice``, ``full``) launch a
    world of ranks once for the run, 4 when ``--device-count`` is absent
    (the multidevice grid itself runs in
    ``tests/test_torch_campaign_multidevice.py``); another grid takes
    ``--device-count`` and runs on one rank, saying so."""
    import repro_torch.sharding as sharding
    from repro_torch.campaign import executor
    from repro_torch.campaign.artifacts import campaign_to_dict
    launched, ran = [], []
    monkeypatch.setattr(sharding, "launch", lambda fn, n, **kw:
                        launched.append((fn.__name__, n, kw["args"][0])))

    def run_campaign(name, specs, **kw):
        ran.append(name)
        return campaign_to_dict(name, list(specs), [], [], 0.0, 0,
                                torch.device("cpu"))
    monkeypatch.setattr(executor, "run_campaign", run_campaign)
    assert cli.main(argv + ["--device", "cpu", "--out", "-"]) == 0
    out = capsys.readouterr().out
    if ranks is None:
        assert launched == [] and len(ran) == 1
        assert "no cell of this grid shards" in out
    else:
        assert launched == [("_grid_rank", ranks, argv[1])] and ran == []


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--grid", "pallas", "--quick", "--samples", "4",
                  "--out", "unused"])
