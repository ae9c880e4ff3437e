"""The port's multi-device training (``repro_torch.launch.steps``'s mesh
steps, ``repro_torch.launch.train``'s ``--mesh``) on 4 ``gloo`` ranks
against JAX's steps on 4 forced host devices, on the CPU.

One world of 4 ranks is launched for the module
(``tests/torch_mesh_ranks.py``) beside one JAX process
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``); both take the
reduced Llama-3.2-1B with the port's seeded weights, two steps of two
microbatches of the same numpy batches (8 x 16 tokens), float32
compute, lr 1e-4.  JAX runs its steps on a one-axis ``("data",)`` mesh:
at jax 0.9 a ``shard_map`` manual over ``data`` and auto over a size-1
``model`` aborts in the partitioner (ROADMAP §C15), and the two meshes
compute the same thing.

* Deferred step (compressed): the summed int32 payloads equal JAX's
  wherever every rank's gradient quantizes to the same code; a split
  at a rounding boundary (the gradients differ by the bf16 attention's
  round-off, ROADMAP §C10) moves a sum by at most one a rank.  Step 0,
  from the same state, splits under 0.5% of the elements; step 1, after
  one step of those splits (in the parameters and the residuals), under
  5% (ROADMAP §C16).  ``comm/errors`` equal (0).
* ZeRO-1: the first moments within ``grad_tolerance(cfg, "bfloat16")``
  of their largest magnitude, the second moments (squares) within twice
  that.
* The CLI's mesh step at d = 2 and 4 against the port's one-device step
  on the global batch, its losses within ``loss_tolerance``.

The parameters (and ZeRO-1's float32 master weights) are held by their
update, the state less the starting one, against the reference's: every
element within :func:`repro_torch.launch.parity.adam_step_tolerance`,
and at most a stated share of them more than ``lr / 100`` apart (Adam
moves nearly every element by about ``lr`` a step, so a step that skips
its update or takes it with another bias correction, weight decay, rate
or gradient moves most of them farther): deferred 5%, ZeRO-1's master
5% and bf16 parameters 1%, the mesh step 0.1%.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduce_cfg as j_reduce  # noqa: E402
from repro.configs.registry import get_arch as j_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.models.base import build_model as j_build  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.parity import (adam_step_tolerance,  # noqa: E402
                                       grad_tolerance, loss_tolerance)
from repro_torch.models.base import build_model  # noqa: E402
from repro_torch.sharding import launch  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = reduce_cfg(get_arch("llama3.2-1b"))
LR = 1e-4

_JAX_SCRIPT = r'''
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from repro.configs import reduce_cfg
from repro.configs.registry import get_arch
from repro.launch import steps as js
from repro.launch.mesh import make_host_mesh
from repro.layers.common import Ctx
from repro.models.base import build_model
from repro.protect import default_plan
from repro.runtime import compression as jc
from repro.sharding import values_of

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
model = build_model(reduce_cfg(get_arch("llama3.2-1b")), max_pos=64)
like = values_of(jax.eval_shape(lambda: model.init(jax.random.key(0))))
leaves, tdef = jax.tree.flatten(like)
params = jax.tree.unflatten(
    tdef, [jnp.asarray(inp[f"p{i}"]) for i in range(len(leaves))])
batches = [{"tokens": jnp.asarray(inp[f"tokens{t}"]),
            "labels": jnp.asarray(inp[f"labels{t}"])} for t in range(2)]
ctx = Ctx(plan=default_plan(), quant=False, compute_dtype=jnp.float32)
mesh = make_host_mesh((4,), ("data",))
kw = dict(accum=2, peak_lr=float(inp["lr"]), warmup=0, total_steps=10)
sums = []
orig = jc.decompress_grads


def seen(summed, scale_sum, n):
    jax.debug.callback(
        lambda s: sums.append(jax.tree.map(np.asarray, s)), summed)
    return orig(summed, scale_sum, n)


jc.decompress_grads = seen
out = {}
step = jax.jit(js.make_train_step_deferred(model, ctx, mesh, **kw))
opt = {"m": jax.tree.map(jnp.zeros_like, params),
       "v": jax.tree.map(jnp.zeros_like, params),
       "count": jnp.zeros((), jnp.int32)}
state = {"params": params, "opt": opt, "step": jnp.zeros((), jnp.int32)}
comm = jc.CompressionState(error=jax.tree.map(
    lambda p: jnp.zeros((4,) + p.shape, jnp.float32), params))
with mesh:
    for t in range(2):
        state, comm, met = step(state, comm, batches[t])
        jax.block_until_ready(state)
        for k in ("comm/errors", "loss_final", "grad_norm"):
            out[f"d_{k}_{t}"] = np.asarray(met[k])
for i, x in enumerate(jax.tree.leaves(state["params"])):
    out[f"d_param{i}"] = np.asarray(x)
per = len(sums) // 2            # the callback runs once a device
for t in range(2):
    for i, x in enumerate(jax.tree.leaves(sums[t * per])):
        out[f"d_sum{t}_{i}"] = x
zstep = jax.jit(js.make_train_step_zero1(model, ctx, mesh, axes=("data",),
                                         **kw))
flat, _ = ravel_pytree(params)
master = jnp.pad(flat, (0, (-flat.shape[0]) % 4))
zs = {"params": jax.tree.map(lambda p: p.astype(jnp.bfloat16), params),
      "opt": {"master": master, "m": jnp.zeros_like(master),
              "v": jnp.zeros_like(master)},
      "step": jnp.zeros((), jnp.int32)}
with mesh:
    for t in range(2):
        zs, met = zstep(zs, batches[t])
        jax.block_until_ready(zs)
        out[f"z_loss_final_{t}"] = np.asarray(met["loss_final"])
for i, x in enumerate(jax.tree.leaves(zs["params"])):
    out[f"z_param{i}"] = np.asarray(x.astype(jnp.float32))
for k in ("master", "m", "v"):
    out[f"z_{k}"] = np.asarray(zs["opt"][k])
np.savez(os.path.join(d, "jax.npz"), **out)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, rank 0's results) of the same inputs: the JAX
    process and the port's world of 4 ranks run side by side."""
    d = tmp_path_factory.mktemp("mesh")
    params = build_model(CFG, max_pos=64).init(3, device="cpu")
    rng = np.random.default_rng(7)
    inputs = {f"p{i}": x.numpy() for i, x in enumerate(tree_leaves(params))}
    for t in range(ranks.STEPS):
        toks = rng.integers(0, CFG.vocab, (ranks.BATCH, ranks.SEQ + 1))
        inputs[f"tokens{t}"] = toks[:, :-1].astype(np.int32)
        inputs[f"labels{t}"] = toks[:, 1:].astype(np.int32)
    inputs["lr"] = np.float32(LR)
    np.savez(d / "inputs.npz", **inputs)
    (d / "jax_steps.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, str(d / "jax_steps.py"),
                             str(d)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mine = launch(ranks.train_mesh_cases, ranks.SHARDS, args=(str(d),))
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    mine["start"] = [inputs[f"p{i}"] for i in range(len(tree_leaves(params)))]
    return dict(np.load(d / "jax.npz")), mine


def _scale(x):
    return max(float(np.abs(x).max()), 1e-30)


#: an update element farther than this from the reference's counts as
#: off: float32 round-off keeps the rest closer
OFF = LR / 100


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_ulp(x):
    """A bf16 value's unit in the last place (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _hold_update(got, want, start, share, moved=0.5, ulp=0.0):
    """The update ``got - start`` against ``want - start`` (flat arrays):
    every element within ``adam_step_tolerance`` (plus ``ulp``, the
    rounding step of a bf16 element whose masters straddle one), at most
    ``share`` of them more than :data:`OFF` apart; and the reference's
    update a real one, more than ``moved`` of its elements farther than
    :data:`OFF` from the start."""
    d_got, d_want = got - start, want - start
    off = np.abs(d_got - d_want)
    assert np.all(off <= adam_step_tolerance(LR, ranks.STEPS) + ulp), \
        off.max()
    assert (off > OFF).mean() <= share, (off > OFF).mean()
    assert (np.abs(d_want) > OFF).mean() > moved


@pytest.mark.parametrize("step,share", [(0, 0.005), (1, 0.05)])
def test_deferred_payload_sums_equal_jax_but_rounding_splits(runs, step,
                                                            share):
    jx, mine = runs
    got = mine["deferred"]["sums"][step]
    split = total = 0
    for i, s in enumerate(got):
        want = jx[f"d_sum{step}_{i}"]
        assert s.dtype == want.dtype == np.int32 and s.shape == want.shape
        delta = np.abs(s.astype(np.int64) - want)
        # each rank's code at most one apart at a rounding boundary
        assert delta.max() <= ranks.SHARDS
        split += int((delta > 0).sum())
        total += want.size
    assert split <= share * total, (split, total)


def test_deferred_comm_errors_and_losses_match_jax(runs):
    jx, mine = runs
    for t, m in enumerate(mine["deferred"]["metrics"]):
        assert m["comm/errors"] == float(jx[f"d_comm/errors_{t}"]) == 0
        want = float(jx[f"d_loss_final_{t}"])
        assert abs(m["loss_final"] - want) <= \
            loss_tolerance(CFG, "float32") * abs(want)


def test_deferred_grad_norm_matches_jax(runs):
    """The global norm of the reduced mean gradient, before the clip,
    equals JAX's within ``grad_tolerance(cfg, "float32")`` of itself:
    Adam's update is blind to the gradient's scale, so this is what
    holds the mean's divisor (the ranks' count)."""
    jx, mine = runs
    tol = grad_tolerance(CFG, "float32")
    for t, m in enumerate(mine["deferred"]["metrics"]):
        want = float(jx[f"d_grad_norm_{t}"])
        assert abs(m["grad_norm"] - want) <= tol * want, (t, want)


def test_deferred_params_within_adam_tolerance(runs):
    """The deferred step's update against JAX's: most elements agree to
    float32 round-off; the split codes move the rest (under 5%)."""
    jx, mine = runs
    got = mine["deferred"]["params"]
    _hold_update(_flat(got), _flat(jx[f"d_param{i}"]
                                   for i in range(len(got))),
                 _flat(mine["start"]), 0.05)


def test_deferred_residuals_are_each_ranks_own(runs):
    """Each rank keeps its own error-feedback residual: the four rows
    differ (each rank quantized its own gradients)."""
    _, mine = runs
    resid = mine["deferred"]["resid"][0]
    assert resid.shape[0] == ranks.SHARDS
    assert not np.array_equal(resid[0], resid[1])


def test_zero1_params_and_shards_within_bf16_tolerance(runs):
    """ZeRO-1's updates against JAX's: the float32 master weights' (under
    5% of the elements off, the bf16 reduce-scatter summing in another
    order) and the bf16 parameters' (under 1%, one rounding step apart
    at most where the masters straddle it; a bf16 parameter moves only
    where its update crosses a rounding step, 42% of them here), which
    are the master weights rounded to bf16; the moments within the bf16
    gradient tolerance."""
    jx, mine = runs
    tol = grad_tolerance(CFG, "bfloat16")
    z = mine["zero1"]
    n = z["opt"]["master"].size
    start = _flat(mine["start"])
    _hold_update(z["opt"]["master"], jx["z_master"][:n], start, 0.05)
    params = _flat(z["params"])
    assert np.array_equal(params, _bf16(z["opt"]["master"]))
    want = _flat(jx[f"z_param{i}"] for i in range(len(z["params"])))
    _hold_update(params, want, _bf16(start), 0.01, moved=0.25,
                 ulp=_bf16_ulp(np.maximum(np.abs(params), np.abs(want))))
    for k, k_tol in (("m", tol), ("v", 2 * tol)):
        want = jx[f"z_{k}"]
        assert want.size == n + (-n) % ranks.SHARDS
        assert np.abs(z["opt"][k] - want[:n]).max() <= \
            k_tol * _scale(want), k
    for t, m in enumerate(z["metrics"]):
        want = float(jx[f"z_loss_final_{t}"])
        assert abs(m["loss_final"] - want) <= \
            loss_tolerance(CFG, "bfloat16") * abs(want)


@pytest.mark.parametrize("d", [2, 4])
def test_cli_mesh_step_equals_the_one_device_step(runs, d):
    """The train CLI's step over d ranks (float gradients mean-all-reduced,
    then the one-device compressed step) against the port's
    ``make_train_step`` on the global batch: the updates apart in under
    0.1% of the elements (the all-reduce's float32 sums in another order
    move a code at a rounding boundary now and then; a rank that trained
    on its own rows would move a quarter or more)."""
    _, mine = runs
    one, got = mine["one_device"], mine[f"mesh{d}"]
    _hold_update(_flat(got["params"]), _flat(one["params"]),
                 _flat(mine["start"]), 0.001)
    for m1, md in zip(one["metrics"], got["metrics"]):
        assert md["comm/errors"] == m1["comm/errors"] == 0
        assert abs(md["loss_final"] - m1["loss_final"]) <= \
            loss_tolerance(CFG, "float32") * abs(m1["loss_final"])


def test_zero1_state_recut_onto_fewer_ranks(runs):
    """Elastic: ZeRO-1's state gathered on 4 ranks, saved by rank 0,
    restored onto 3 and re-cut: each block is its cut of the full copy,
    and gathering the 3 blocks gives the copy back bit for bit."""
    _, mine = runs
    el = mine["elastic"]
    assert el["cuts_equal"] and el["round_trip"]
    n = mine["zero1"]["opt"]["master"].size
    assert el["block"] == -(-n // 3)


def test_loop_over_the_mesh_checkpoints_rank0_and_restores(runs):
    """The CLI's loop on 4 ranks: rank 0 alone writes the replicated
    state (one shard, JAX's layout); every rank restores that copy
    equal to its own state."""
    _, mine = runs
    ck = mine["ckpt"]
    assert ck["files"] == ["COMMIT", "MANIFEST.json", "shard_00000.npz"]
    assert ck["restored_step"] == ranks.STEPS and ck["restored_equal"]
    assert ck["stats"] == {"recomputes": 0, "restores": 0,
                           "faulty_steps": 0}


def test_zero1_state_shapes_and_comm_state_match_jax():
    """``zero1_state_shapes`` (JAX's ``zero1_state_sds``: the padded flat
    length, the dtypes) and ``init_comm_state`` (a leading data axis)."""
    jm = j_build(j_reduce(j_arch("llama3.2-1b")), max_pos=64)
    sds, _, _ = jsteps.zero1_state_sds(jm, j_host_mesh((1,), ("data",)),
                                       axes=("data",))
    model = build_model(CFG, max_pos=64)
    for n in (1, 3, 4):
        st, axes = tsteps.zero1_state_shapes(model, n)
        d = sds["opt"]["master"].shape[0]
        assert st["opt"]["master"].shape == (d + (-d) % n,)
        assert axes["opt"]["master"] == ("flat",)
    assert [tuple(x.shape) for x in tree_leaves(st["params"])] == \
        [x.shape for x in jax.tree.leaves(sds["params"])]
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(st["params"]))
    jc = jsteps.init_comm_state(sds["params"], 4)
    tc = tsteps.init_comm_state(st["params"], 4)
    assert [tuple(x.shape) for x in tree_leaves(tc.error)] == \
        [x.shape for x in jax.tree.leaves(jc.error)]
    assert jnp.float32 == jax.tree.leaves(jc.error)[0].dtype


def test_cli_trains_on_a_data_mesh(tmp_path, capfd):
    """``--mesh-shape 2,1 --device-count 2 --compress`` launches 2 gloo
    ranks; rank 0 logs the steps and writes the checkpoint."""
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--smoke", "--mesh-shape", "2,1",
                       "--device-count", "2", "--compress", "--steps", "10",
                       "--seq-len", "16", "--batch", "4", "--ckpt-dir",
                       str(tmp_path / "ck")]) == 0
    err = capfd.readouterr().err
    assert "mesh=(2, 1)" in err and "step 10 loss=" in err
    done = [ln for ln in err.splitlines() if " done: " in ln]
    assert len(done) == 1 and "'comm/errors': 0.0" in done[0]
    assert "'faulty_steps': 0" in done[0]
    assert sorted(os.listdir(tmp_path / "ck" / "step_000000010")) == \
        ["COMMIT", "MANIFEST.json", "shard_00000.npz"]


@pytest.mark.parametrize("arch,linear", [("llama3.2-1b", True),
                                         ("granite-moe-3b-a800m", False)])
def test_mesh_loss_is_the_mean_of_the_shards_but_for_moe(arch, linear):
    """Why the train CLI refuses a MoE on a data mesh (ROADMAP §C17): the
    mesh step's loss is the mean of the ranks' losses, which for a dense
    model is the loss of the global batch within ``loss_tolerance``; the
    MoE's load-balance loss is a product of means over the whole batch,
    so its halves' mean is not (1.75e-4 of the loss off here)."""
    from repro_torch.layers.common import Ctx
    from repro_torch.protect import default_plan
    cfg = reduce_cfg(get_arch(arch))
    model = build_model(cfg, max_pos=64)
    params = model.init(3, device="cpu")
    ctx = Ctx(plan=default_plan(), quant=False, compute_dtype=torch.float32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (8, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    with torch.no_grad():
        whole = float(model.loss(params, batch, ctx)[0])
        halves = [float(model.loss(params, {k: v[h * 4:(h + 1) * 4]
                                            for k, v in batch.items()},
                                   ctx)[0]) for h in range(2)]
    off = abs(whole - sum(halves) / 2) / abs(whole)
    assert (off <= loss_tolerance(cfg, "float32")) == linear, off


@pytest.mark.parametrize("argv,says", [
    (["--mesh-shape", "2,2"], (2, 2)),
    (["--arch", "granite-moe-3b-a800m", "--mesh-shape", "2,1",
      "--device-count", "2"], "mesh=(2, 1)"),
    (["--mesh-shape", "4,1", "--device-count", "2"],
     "needs 4 devices but only 2 are available"),
    (["--mesh", "single"], "cannot reshape array of size 1 into shape "
                           "(16,16)"),
    (["--mesh", "multi", "--device-count", "512"], (2, 16, 16))])
def test_cli_refuses_what_the_port_cannot_run(capfd, tmp_path, argv, says):
    """What the port runs now: a model axis and the production mesh on a
    world of its 512 ranks resolve to their meshes (checked without
    launching: ``_mesh_ranks``); a MoE trains on a data mesh (its
    load-balance statistics all-reduced, §C17).  What it still refuses
    exits with 2 naming the ROADMAP item: a production mesh on a small
    world (JAX's error on a host) and too few ranks."""
    from repro_torch.launch import train
    if isinstance(says, tuple):
        ap = train.build_parser()
        assert train._mesh_ranks(ap, ap.parse_args(
            ["--smoke", "--device", "cpu"] + argv)) == says
        return
    if says.startswith("mesh="):
        assert train.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--seq-len", "16", "--batch", "4", "--ckpt-dir",
                           str(tmp_path)] + argv) == 0
        err = capfd.readouterr().err
        assert says in err and "'faulty_steps': 0" in err
        return
    with pytest.raises(SystemExit) as ei:
        train.main(["--smoke", "--device", "cpu"] + argv)
    assert ei.value.code == 2
    err = capfd.readouterr().err
    assert says in err and "ROADMAP A8." in err
