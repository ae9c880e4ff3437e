"""The port's logical sharding, meshes and elastic plan
(``repro_torch.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.runtime.elastic``, ``repro_torch.data.shard_batch``)
against the JAX package's, on the CPU.

Specs are tuples in both packages (JAX's ``PartitionSpec`` is one), so
``spec_for``, the ``specs_of`` trees and each family's axes tree are
compared exactly; ``plan_remesh`` too, errors included.  The meshes,
the data mesh's collectives and the blocks :func:`remesh_state` cuts
run on one world of 4 ``gloo`` ranks launched once for the module; the
train rules' FSDP blocks are held to ``distribute_tensor``'s local
shards under the placements :func:`placements_of` gives (exact: a
block is a slice).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from helpers import given, settings, st  # noqa: E402
from repro.configs import reduce_cfg as j_reduce  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import get_arch as j_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_production_mesh as j_prod  # noqa: E402
from repro.models.base import build_model as j_build  # noqa: E402
from repro.runtime import elastic as j_el  # noqa: E402
from repro.sharding import is_lp  # noqa: E402
from repro.sharding import logical as j_log  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import BatchShard, Prefetcher, shard_batch  # noqa: E402
from repro_torch.launch.mesh import production_grid  # noqa: E402
from repro_torch.launch.steps import train_state_shapes  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    constrain, launch, placements_for, rules, spec_for, specs_of)
from repro_torch.sharding.logical import tree_of_specs_leaves  # noqa: E402

ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "rwkv6-1.6b",
         "whisper-large-v3", "hymba-1.5b", "llava-next-mistral-7b",
         "internlm2-20b", "qwen3-8b"]
NAMES = [None, "batch", "embed", "mlp", "mlp_in", "heads_x", "vocab",
         "expert", "expert_mlp", "kv_seq", "layers", "frontend", "other"]
MAPS = [None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
        ("model", "data"), "absent"]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256]


def _case(seed):
    rng = np.random.default_rng(seed)
    nd = int(rng.integers(0, 5))
    shape = tuple(int(rng.choice(DIMS)) for _ in range(nd))
    axes = tuple(NAMES[int(rng.integers(len(NAMES)))] for _ in range(nd))
    rule_set = {n: MAPS[int(rng.integers(len(MAPS)))]
                for n in NAMES if n is not None and rng.random() < 0.8}
    mesh = {a: int(rng.choice(sizes)) for a, sizes in
            (("data", [1, 2, 4, 16]), ("model", [1, 2, 3, 16]),
             ("pod", [1, 2])) if rng.random() < 0.8}
    return shape, axes, rule_set, mesh


@settings(max_examples=400)
@given(st.integers(0, 2**31 - 1))
def test_spec_for_equals_jax(seed):
    """Drawn shapes, axes, rules and mesh shapes: the same tuple (the
    divisibility fall-back, no mesh axis used twice, trailing Nones
    trimmed)."""
    shape, axes, rule_set, mesh = _case(seed)
    want = tuple(j_log.spec_for(shape, axes, rule_set, mesh))
    assert spec_for(shape, axes, rule_set, mesh) == want


def _j_model(arch):
    return j_build(j_reduce(j_arch(arch)), max_pos=64)


def _t_model(arch):
    return build_model(reduce_cfg(get_arch(arch)), max_pos=64)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_jax_logical_params(arch, quant):
    """Each family's ``param_axes()`` is the axes of JAX's ``LogicalParam``
    tree (``jax.eval_shape(model.init)``), leaf for leaf at reduced size,
    float and int8 serving forms."""
    lp = jax.eval_shape(lambda: _j_model(arch).init(jax.random.key(0),
                                                    quant=quant))
    want = [p.axes for p in jax.tree.leaves(lp, is_leaf=is_lp)]
    assert tree_of_specs_leaves(_t_model(arch).param_axes(quant=quant)) \
        == want


def _fake_mesh(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (16, 16)])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_specs_of_trees_equal_jax(mode, mesh_shape):
    """``specs_of`` of the parameter, training-state (with the
    residuals) and batch trees under ``train_rules`` / ``serve_rules``
    equals JAX's ``specs_of`` tree for llama, granite (the expert axis)
    and whisper (the encoder's stacks).  Only specs are compared, so no
    256-rank world is needed."""
    rule_set = getattr(rules, f"{mode}_rules")()
    assert rule_set == getattr(j_rules, f"{mode}_rules")()
    jmesh = _fake_mesh(mesh_shape)
    tmesh = dict(zip(jmesh.axis_names, mesh_shape))
    shape = ShapeConfig("t", "train", 64, 16)
    for arch in ("llama3.2-1b", "granite-moe-3b-a800m", "whisper-large-v3"):
        jm, tm = _j_model(arch), _t_model(arch)
        trees = [
            (jax.eval_shape(lambda: jm.init(jax.random.key(0))),
             tm.param_axes(), tm.init(0, device="meta")),
            (jsteps.train_state_lp(jm, compress=True),
             tm.train_state_axes(compress=True),
             train_state_shapes(tm, compress=True)),
            (jm.input_specs(JShape("t", "train", 64, 16)),
             tm.input_axes(shape), tm.input_specs(shape)),
        ]
        for j_tree, t_axes, t_shapes in trees:
            want = [tuple(s) for s in jax.tree.leaves(
                j_log.specs_of(j_tree, rule_set, jmesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
            got = tree_of_specs_leaves(specs_of(t_axes, t_shapes, rule_set,
                                                tmesh))
            assert got == want, arch


@pytest.mark.parametrize("n,mp,old", [(256, 16, None), (250, 16, (16, 16)),
                                      (16, 16, None), (8, 2, (5, 2)),
                                      (7, 1, None), (15, 16, None),
                                      (0, 4, None)])
def test_plan_remesh_equals_jax(n, mp, old):
    """The plan (shapes, axes, dropped devices, data parallelism) and, for
    too few devices, the error."""
    try:
        want = j_el.plan_remesh(n, model_parallel=mp, old_shape=old)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            elastic.plan_remesh(n, model_parallel=mp, old_shape=old)
        return
    got = elastic.plan_remesh(n, model_parallel=mp, old_shape=old)
    assert (got.old_shape, got.new_shape, got.axes, got.dropped_devices,
            got.data_parallel) == (want.old_shape, want.new_shape,
                                   want.axes, want.dropped_devices,
                                   want.data_parallel)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_error_is_jax_on_a_host(multi_pod):
    """A world smaller than 256 (512) ranks: the message JAX gives on
    a one-device host."""
    with pytest.raises(ValueError) as want:
        j_prod(multi_pod=multi_pod)
    with pytest.raises(ValueError) as got:
        production_grid(multi_pod, world_size=1)
    assert str(got.value) == str(want.value)
    assert production_grid(multi_pod, 512).shape == \
        ((2, 16, 16) if multi_pod else (16, 16))


def test_placements_and_constrain():
    """A spec's placements (``Shard`` where a tensor dimension is split
    over the mesh axis, else ``Replicate``); ``constrain`` returns a
    plain tensor as it is, on a data mesh and on a model mesh, whose
    step's tensors are ``DTensor`` s (A8.4)."""
    from torch.distributed.tensor import Replicate, Shard
    assert placements_for(("data", None, ("pod", "model")),
                          ("pod", "data", "model")) == \
        (Shard(2), Shard(0), Shard(2))
    assert placements_for((), ("data", "model")) == (Replicate(),
                                                     Replicate())
    x = torch.ones(4, 8)
    r = rules.train_rules()
    assert constrain(x, ("batch", "embed"), r, {"data": 4, "model": 1}) is x
    assert constrain(x, ("batch", "embed"), None, {"data": 4}) is x
    assert constrain(x, ("batch", "embed"), r, {"data": 2, "model": 2}) \
        is x


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_shard_batch_splits_every_microbatch(accum):
    """Each rank takes its block of every microbatch (JAX shards the
    global batch, then splits it into microbatches): the ranks' i-th
    microbatches together are the global i-th microbatch, in rank
    order; with one microbatch a rank's rows are a contiguous block
    (JAX's ``P("data")``)."""
    b, n = 16, 4
    batch = {"tokens": np.arange(b * 3).reshape(b, 3),
             "labels": torch.arange(b)}
    parts = [shard_batch(batch, BatchShard(r, n, accum)) for r in range(n)]
    for k in batch:
        for i in range(accum):
            mb = [np.asarray(p[k]).reshape((accum, -1) + p[k].shape[1:])[i]
                  for p in parts]
            want = np.asarray(batch[k]).reshape(
                (accum, -1) + tuple(batch[k].shape[1:]))[i]
            np.testing.assert_array_equal(np.concatenate(mb), want)
    if accum == 1:
        np.testing.assert_array_equal(parts[1]["tokens"],
                                      batch["tokens"][4:8])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": np.zeros(6)}, BatchShard(0, 4))


def test_prefetcher_takes_the_rank_rows():
    batches = [{"x": np.arange(8) + 10 * t} for t in range(3)]
    with Prefetcher(iter(batches), shardings=BatchShard(1, 2)) as pf:
        got = [b["x"].tolist() for b in pf]
    assert got == [[4, 5, 6, 7], [14, 15, 16, 17], [24, 25, 26, 27]]


@pytest.fixture(scope="module")
def world4():
    """One world of 4 gloo ranks for every multi-rank case here."""
    import torch_mesh_ranks
    return launch(torch_mesh_ranks.sharding_cases, 4)


def test_data_mesh_all_reduces_over_its_ranks(world4):
    size, rank, summed, names = world4["data_mesh"]
    assert (size, rank, names) == (4, 0, ("data",))
    assert summed == [6.0, 6.0, 6.0]          # 0 + 1 + 2 + 3
    # rank 0 is outside the (2, 3) slice; the slice reduced over two
    assert world4["half"] == (False, None)


def test_host_and_plan_meshes(world4):
    assert world4["host"] == ((2, 2), ("data", "model"), (0, 0))
    assert world4["plan_mesh"] == ((2, 2), ("data", "model"))


def test_remesh_state_blocks_are_dtensor_shards(world4):
    """Serve rules replicate the reduced Llama on a (4, 1) mesh; train
    rules cut the ``embed`` dimensions over ``data`` (FSDP), each block
    equal to ``distribute_tensor``'s local shard under
    :func:`placements_of`'s placements."""
    assert world4["serve_replicated"]
    assert world4["fsdp_blocks_equal_dtensor"]
    assert world4["fsdp_leaves_split"] == sum(
        "data" in s for s in world4["specs"]) > 0
