"""The dry run's own ways with ``DTensor`` (``repro_torch.launch.dryrun``):
the gathers and scatters it takes as GSPMD partitions them, the
elementwise strategies it lends ``DTensor`` for one fake world only, and
the PyTorch release each record names.  Meta tensors on a fake world of
4 ranks in this process.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.abft_kvcache import set_rows  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.costs import CostCounter  # noqa: E402
from repro_torch.models.base import cross_entropy  # noqa: E402


def _placed(shape, mesh, placements, dtype=torch.float32):
    return dr._place(torch.empty(shape, dtype=dtype, device="meta"), mesh,
                     placements)


def _largest_collective(counter) -> float:
    return max((raw for _, raw, _ in counter.collective_log), default=0.0)


def test_decode_cache_write_keeps_the_cache_sharded():
    """A decode step's row write into a cache split over batch (data) and
    sequence (model) stays split, and moves the rows, never the cache."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    with dr.fake_world(4):
        mesh = dr.make_mesh((2, 2), ("data", "model"))
        cache = _placed((4, 2, 8, 4), mesh, [Shard(0), Shard(2)],
                        torch.bfloat16)
        pos = _placed((4,), mesh, [Shard(0), Replicate()], torch.int32)
        rows = _placed((4, 2, 4), mesh, [Shard(0), Replicate()])
        counter = CostCounter(dtensor_hook=dr.gspmd_hook)
        with implicit_replication(), counter:
            out = set_rows(cache, torch.arange(4, device="meta"), pos, rows)
        assert tuple(out.shape) == (4, 2, 8, 4)
        assert out.placements == cache.placements
    cache_bytes = 4 * 2 * 8 * 4 * 2
    assert 0 < _largest_collective(counter) < cache_bytes / 2


def test_token_lookup_keeps_the_batch_split():
    """A lookup in a token table split over the vocabulary (model), by
    tokens split over the batch (data): each rank looks its own tokens
    up in its own rows, and the result stays split over the batch; the
    table never moves."""
    from torch.distributed.tensor import Replicate, Shard
    with dr.fake_world(4):
        mesh = dr.make_mesh((2, 2), ("data", "model"))
        table = _placed((64, 4), mesh, [Replicate(), Shard(0)])
        ids = _placed((8, 1), mesh, [Shard(0), Replicate()], torch.int64)
        with CostCounter(dtensor_hook=dr.gspmd_hook) as counter:
            out = table[ids]
        assert tuple(out.shape) == (8, 1, 4)
        assert out.placements == (Shard(0), Replicate())
        assert tuple(out._local_tensor.shape) == (4, 1, 4)
    assert 0 < _largest_collective(counter) <= 4 * 1 * 4 * 4


def test_cross_entropy_gather_and_its_gradient_stay_sharded():
    """The label's logit over a vocabulary split on ``model``: each rank
    gathers from its shard, and the gradient's scatter fills a buffer of
    that shard (``DTensor``'s own gather would scatter into the whole
    vocabulary), with no collective of the logits' size."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    vocab = 1024
    with dr.fake_world(4):
        mesh = dr.make_mesh((2, 2), ("data", "model"))
        logits = _placed((4, 3, vocab), mesh, [Shard(0), Shard(2)])
        logits.requires_grad_(True)
        labels = _placed((4, 3), mesh, [Shard(0), Replicate()], torch.int64)
        counter = CostCounter(dtensor_hook=dr.gspmd_hook)
        with implicit_replication(), dr.GspmdGather(), counter:
            loss = cross_entropy(logits, labels, vocab)
            loss.backward()
        assert tuple(loss.shape) == ()
        assert logits.grad.placements == logits.placements
    shard_bytes = 2 * 3 * vocab // 2 * 4
    sites = counter.memory()["peak_sites"]
    assert max(v for k, v in sites.items() if "scatter" in k) <= shard_bytes
    assert _largest_collective(counter) < shard_bytes


def test_fake_world_takes_its_elementwise_strategies_out():
    """An elementwise op ``DTensor`` has no strategy for gets one from
    the dry run's hook, for that fake world only."""
    from torch.distributed.tensor import DTensor, Shard
    lib = torch.library.Library("dryrun_hooks_test", "DEF")
    lib.define("twice(Tensor x) -> Tensor", tags=(torch.Tag.pointwise,))
    lib.impl("twice", lambda x: torch.empty_like(x), "Meta")
    op = torch.ops.dryrun_hooks_test.twice.default
    prop = DTensor._op_dispatcher.sharding_propagator

    def known() -> bool:
        return any(op in t for t in vars(prop).values()
                   if isinstance(t, dict))

    with dr.fake_world(4):
        mesh = dr.make_mesh((4,), ("data",))
        x = _placed((8, 2), mesh, [Shard(0)])
        with pytest.raises(NotImplementedError, match="sharding strategy"):
            op(x)
        with CostCounter(dtensor_hook=dr.gspmd_hook) as c:
            y = op(x)
        assert known() and y.placements == (Shard(0),)
        assert c.result()["flops"] == 8 * 2 / 4
    assert not known()
    with dr.fake_world(4):
        x = _placed((8, 2), dr.make_mesh((4,), ("data",)), [Shard(0)])
        with pytest.raises(NotImplementedError, match="sharding strategy"):
            op(x)


def test_records_name_their_torch_release(tmp_path, monkeypatch):
    rec = dr.run_cell("llama3.2-1b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skipped" and rec["torch"] == torch.__version__
    monkeypatch.setattr(dr, "VALIDATED_TORCH",
                        (".".join(torch.__version__.split(".")[:2]),))
    assert dr.torch_release_flag() is None
    monkeypatch.setattr(dr, "VALIDATED_TORCH", ("0.1",))
    flag = dr.torch_release_flag()
    assert torch.__version__ in flag and "0.1" in flag
