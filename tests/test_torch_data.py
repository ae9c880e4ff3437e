"""The port's synthetic data pipeline against the JAX package's: both
draw every batch from numpy's generator seeded by (seed, step), so the
batches are equal bit for bit."""
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_arch as j_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import pipeline as J  # noqa: E402
from repro_torch.configs import get_arch as t_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.data import pipeline as T  # noqa: E402


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (7, 3)])
@pytest.mark.parametrize("rows", [None, 1000])
def test_dlrm_batches_equal_jax(seed, step, rows):
    dc_j, dc_t = J.DataConfig(seed=seed), T.DataConfig(seed=seed)
    j = J.make_dataset(j_arch("dlrm"), JShape("s", "prefill", 1, 10), dc_j)
    t = T.make_dataset(t_arch("dlrm"), TShape("s", "prefill", 1, 10), dc_t)
    assert isinstance(t, T.SyntheticDLRMDataset)
    jb, tb = j.batch_at(step, table_rows=rows), t.batch_at(
        step, table_rows=rows)
    _equal(jb, tb)
    assert tb["bags"].shape == (26, 10, 128)
    assert int(tb["bags"].max()) < (rows or 4_000_000)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_lm_batches_equal_jax(kind):
    j = J.make_dataset(j_arch("rwkv6-1.6b"), JShape("s", kind, 24, 3))
    t = T.make_dataset(t_arch("rwkv6-1.6b"), TShape("s", kind, 24, 3))
    assert isinstance(t, T.SyntheticLMDataset)
    for step in (0, 1, 9):
        _equal(j.batch_at(step), t.batch_at(step))
    assert ("labels" in t.batch_at(0)) == (kind == "train")


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-8b",
                                  "granite-moe-3b-a800m"])
def test_decoder_lm_batches_equal_jax(arch, kind):
    """The dense and MoE decoder LMs, once refused, get JAX's batches."""
    j = J.make_dataset(j_arch(arch), JShape("s", kind, 24, 3))
    t = T.make_dataset(t_arch(arch), TShape("s", kind, 24, 3))
    assert isinstance(t, T.SyntheticLMDataset)
    for step in (0, 1, 9):
        _equal(j.batch_at(step), t.batch_at(step))
    assert int(t.batch_at(0)["tokens"].max()) < t_arch(arch).vocab


def test_iteration_is_batch_at_in_order():
    t = T.make_dataset(t_arch("dlrm"), TShape("s", "prefill", 1, 4))
    for step, b in enumerate(itertools.islice(iter(t), 3)):
        _equal(b, t.batch_at(step))


def test_other_families_raise_naming_their_item():
    """The families that raised until ROADMAP A7's serving slice (vlm,
    encdec, hybrid) now get JAX's batches: the patch and frame stubs
    drawn before the tokens, the meta tokens counted in the length."""
    for arch in ("llava-next-mistral-7b", "whisper-large-v3", "hymba-1.5b"):
        j = J.make_dataset(j_arch(arch), JShape("s", "train", 600, 2))
        t = T.make_dataset(t_arch(arch), TShape("s", "train", 600, 2))
        assert isinstance(t, T.SyntheticLMDataset)
        for step in (0, 4):
            _equal(j.batch_at(step), t.batch_at(step))
    assert T.make_dataset(t_arch("hymba-1.5b"), TShape(
        "s", "train", 600, 2)).batch_at(0)["tokens"].shape == (2, 600 - 128)


def test_prefetcher_yields_the_batches_in_order_on_the_device():
    t = T.make_dataset(t_arch("dlrm"), TShape("s", "prefill", 1, 4))
    with T.Prefetcher(itertools.islice(iter(t), 5), device="cpu",
                      depth=2) as pf:
        got = list(pf)
    assert len(got) == 5
    for step, b in enumerate(got):
        assert all(isinstance(v, torch.Tensor) for v in b.values())
        _equal({k: v.numpy() for k, v in b.items()}, t.batch_at(step))
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_close_stops_an_endless_stream():
    t = T.make_dataset(t_arch("dlrm"), TShape("s", "prefill", 1, 2))
    pf = T.Prefetcher(iter(t), depth=2)
    first = next(pf)
    _equal(first, t.batch_at(0))
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() >= 1


def test_prefetcher_raises_the_source_error():
    def bad():
        yield {"x": np.zeros(2)}
        raise ValueError("source failed")

    pf = T.Prefetcher(bad())
    assert next(pf)["x"].shape == (2,)
    with pytest.raises(ValueError, match="source failed"):
        next(pf)
    pf.close()
