"""The port's tensor-parallel training (``repro_torch.launch.steps``'s
model-mesh step, ROADMAP A8.4) on 4 ``gloo`` ranks against the JAX train
CLI's jitted step on 4 forced host devices, on the CPU.

One world of 4 ranks is launched for the module
(``tests/torch_tp_ranks.py``) beside one JAX process
(``tests/torch_tp_reference.py``); both take each reduced arch with the
port's seeded weights (seed 3), two steps of the same numpy batches
(8 x 16 tokens), float32 compute, lr 1e-4, under ``train_rules`` (FSDP
over ``data``, tensor parallelism over ``model``).

* Llama-3.2-1B, granite-moe, Mistral-Large and Llama-4-Scout on a (2, 2)
  mesh, and Llama on a (1, 2) one: each step's loss and grad norm, and
  the parameters' update, against JAX's step on the same mesh.  The
  first step's loss (the same state) within ``loss_tolerance(cfg,
  "float32", sharded=True)`` (a MoE's dispatch rounds its rows to bf16,
  so a partial sum in another order upstream moves its loss by up to
  1e-4 of itself: ROADMAP §C19), the second's within
  ``trained_loss_tolerance`` (after a step of Adam's normalized
  updates: JAX's own meshes part by 2e-5 there), each grad norm within
  ``grad_tolerance``, the update within ``adam_step_tolerance`` with at
  most ``update_share`` of its elements more than ``lr / 100`` apart
  (§C16's rule).
* granite on a (2, 1) data mesh (the CLI's replicated step, its
  load-balance statistics all-reduced over the data group): its first
  loss equal to JAX's global-batch step within ``loss_tolerance``
  (ROADMAP §C17: the mean of the halves' losses was 1.75e-4 off), and
  its whole run the port's one-device step on the global batch.
* A (1, 1) model mesh equals the one-device step bit for bit.
* A (2, 2) state saved through the loop (each leaf gathered to rank 0)
  and restored by re-cutting to the placements.
* Each branch of ``repro_torch.sharding.gspmd`` (shared with the dry
  run) computing values on real ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_ranks as ranks  # noqa: E402
import torch_tp_reference as reference  # noqa: E402

from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.launch.parity import (adam_step_tolerance,  # noqa: E402
                                       grad_tolerance, loss_tolerance,
                                       trained_loss_tolerance, update_share)
from repro_torch.sharding import launch  # noqa: E402

LR = ranks.LR
#: an update element farther than this from the reference's counts as off
OFF = LR / 100


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, rank 0's results) of the same inputs: the JAX
    process and the port's world of 4 ranks run side by side."""
    d = tmp_path_factory.mktemp("tp")
    inputs = ranks.make_inputs(str(d / "inputs.npz"))
    cases = [[a, list(s)] for a, s in ranks.TP_CASES + [ranks.DATA_CASE]]
    proc = reference.start(str(d), cases)
    try:
        mine = launch(ranks.tp_cases, 4, args=(str(d),))
    finally:
        reference.finish(proc)
    return dict(np.load(d / "jax.npz")), mine, inputs


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def _start(inputs, arch):
    n = sum(1 for k in inputs if k.startswith(f"{arch}/p"))
    return _flat(inputs[f"{arch}/p{i}"] for i in range(n))


def _hold(got, want, cfg, tag, sharded=True):
    """Loss and grad norm a step against the reference's (``want``:
    JAX's arrays under ``tag``)."""
    for t, m in enumerate(got["metrics"]):
        loss = float(want[f"{tag}/loss_final{t}"])
        tol = loss_tolerance(cfg, "float32", sharded=sharded) if t == 0 \
            else trained_loss_tolerance(cfg, "float32")
        assert abs(m["loss_final"] - loss) <= tol * abs(loss), \
            (t, m["loss_final"], loss)
        gn = float(want[f"{tag}/grad_norm{t}"])
        assert abs(m["grad_norm"] - gn) <= grad_tolerance(
            cfg, "float32") * gn, (t, m["grad_norm"], gn)


def _hold_update(got, want, start, share):
    d_got, d_want = got - start, want - start
    off = np.abs(d_got - d_want)
    assert np.all(off <= adam_step_tolerance(LR, ranks.STEPS)), off.max()
    assert (off > OFF).mean() <= share, (off > OFF).mean()
    assert (np.abs(d_want) > OFF).mean() > 0.5


@pytest.mark.parametrize("arch,shape", ranks.TP_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in
                              ranks.TP_CASES])
def test_model_mesh_step_against_jax(runs, arch, shape):
    jx, mine, inputs = runs
    cfg = reduce_cfg(get_arch(arch))
    tag = f"{arch}@{shape[0]}x{shape[1]}"
    got = mine["tp"][arch, shape]
    _hold(got, jx, cfg, tag)
    n = len(got["params"])
    _hold_update(_flat(got["params"]),
                 _flat(jx[f"{tag}/param{i}"] for i in range(n)),
                 _start(inputs, arch), update_share(cfg))


def test_moe_on_a_data_mesh_is_the_global_batch_step(runs):
    """§C17 closed: granite's data-mesh step (each rank's rows, the
    load-balance statistics all-reduced over the data group, the mean of
    the ranks' gradients) against JAX's step on the global batch, with
    no model axis (so no relaxation for the first loss); and against the
    port's one-device step on the global batch: the losses within
    ``loss_tolerance`` and at most 0.1% of the update's elements more
    than ``lr / 100`` apart (the all-reduce's sums in another order)."""
    jx, mine, inputs = runs
    arch, shape = ranks.DATA_CASE
    cfg = reduce_cfg(get_arch(arch))
    tag = f"{arch}@{shape[0]}x{shape[1]}"
    got, one = mine["data"], mine["one_device"][arch]
    _hold(got, jx, cfg, tag, sharded=False)
    start = _start(inputs, arch)
    n = len(got["params"])
    _hold_update(_flat(got["params"]),
                 _flat(jx[f"{tag}/param{i}"] for i in range(n)), start,
                 update_share(cfg))
    for m, m1 in zip(got["metrics"], one["metrics"]):
        assert abs(m["loss_final"] - m1["loss_final"]) <= loss_tolerance(
            cfg, "float32") * abs(m1["loss_final"])
    _hold_update(_flat(got["params"]), _flat(one["params"]), start, 0.001)


def test_one_by_one_mesh_is_the_one_device_step(runs):
    _, mine, _ = runs
    one, got = mine["one_device"][ranks.ARCHS[0]], mine["one_by_one"]
    assert got["metrics"] == one["metrics"]
    assert all(np.array_equal(a, b) for a, b in zip(got["params"],
                                                    one["params"]))


def test_sharded_state_checkpoint_round_trip(runs):
    """The loop on (2, 2): rank 0 alone writes the gathered state (one
    shard, JAX's layout); every rank's restored blocks equal its own."""
    _, mine, _ = runs
    ck = mine["ckpt"]
    assert ck["files"] == ["COMMIT", "MANIFEST.json", "shard_00000.npz"]
    assert ck["restored_step"] == ranks.STEPS and ck["ranks_equal"] == 4
    assert ck["sharded_leaves"] > 0
    assert ck["stats"] == {"recomputes": 0, "restores": 0,
                           "faulty_steps": 0}


#: the shared branches that sum in another order than the plain op
_REORDERED = {"partial_product": 1e-6, "logsumexp": 1e-6, "gather": 1e-6}
_BRANCHES = ["c10d", "partial_product", "pointwise", "factory",
             "index_gather", "index_put_add", "index_put_set", "argmax",
             "logsumexp", "masked_view", "retile", "gloo_collectives",
             "gather", "vocab_lookup"]


@pytest.mark.parametrize("branch", _BRANCHES)
def test_shared_branch_computes_values_on_ranks(runs, branch):
    _, mine, _ = runs
    err, scale = mine["branches"][branch]
    assert err <= _REORDERED.get(branch, 0.0) * scale, (err, scale)
