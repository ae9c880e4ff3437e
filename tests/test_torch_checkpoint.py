"""The port's checksummed checkpoints (``repro_torch.checkpoint``)
against the JAX package's (``repro.checkpoint``), on the CPU.

The on-disk layout is shared: each package restores the other's
checkpoint of the same training state (reduced Llama-3.2-1B: params,
AdamW moments and count, step, the compression residuals), leaf for
leaf in ``jax.tree.flatten`` order, bfloat16 included, and both write
the same per-leaf checksums.  The corruption, torn-write, garbage
collection and fallback cases mirror ``tests/test_substrate.py``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.configs import reduce_cfg as j_reduce  # noqa: E402
from repro.configs.registry import get_arch as j_arch  # noqa: E402
from repro.launch.steps import init_train_state as j_init  # noqa: E402
from repro.models.base import build_model as j_build  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.steps import init_train_state  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402
from repro_torch.runtime.compression import CompressionState  # noqa: E402


def _small():
    """The substrate test's state, in the port's tensors."""
    return {"params": {"w": torch.arange(24.0).reshape(4, 6),
                       "b": torch.ones((6,), dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}


def _j_small():
    return {"params": {"w": jnp.arange(24.0).reshape(4, 6),
                       "b": jnp.ones((6,), jnp.bfloat16)},
            "step": jnp.zeros((), jnp.int32)}


@pytest.fixture(scope="module")
def states():
    """The JAX reduced-Llama training state (compress=True) on the host,
    and the port's state of the same structure (its own values)."""
    jm = j_build(j_reduce(j_arch("llama3.2-1b")), max_pos=64)
    js = jax.device_get(jax.jit(lambda k: j_init(jm, k, compress=True))(
        jax.random.key(0)))
    js["params"]["final_norm"]["scale"] = \
        np.asarray(js["params"]["final_norm"]["scale"], jnp.bfloat16)
    ts = init_train_state(build_model(reduce_cfg(get_arch("llama3.2-1b"))),
                          1, compress=True, device="cpu")
    ts["params"]["final_norm"]["scale"] = \
        ts["params"]["final_norm"]["scale"].to(torch.bfloat16)
    return js, ts


def _assert_same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if b.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(a.view(np.int16),
                                          b.view(torch.int16).numpy())
        else:
            assert a.dtype == b.numpy().dtype
            np.testing.assert_array_equal(a, b.numpy())


def test_port_reads_the_jax_checkpoint(tmp_path, states):
    js, ts = states
    jck.save_checkpoint(str(tmp_path), 7, js)
    assert tck.latest_step(str(tmp_path)) == 7
    back = tck.load_checkpoint(str(tmp_path), 7, ts)
    assert isinstance(back["comm"], CompressionState)
    _assert_same(js, back)


def test_jax_reads_the_port_checkpoint(tmp_path, states):
    js, ts = states
    tck.save_checkpoint(str(tmp_path), 3, ts)
    assert jck.latest_step(str(tmp_path)) == 3
    back = jck.load_checkpoint(str(tmp_path), 3, js)
    _assert_same(back, ts)


def test_both_write_the_same_checksums(tmp_path, states):
    js, _ = states
    from repro_torch.models.convert import from_jax
    ts = from_jax(js, device="cpu")
    jck.save_checkpoint(str(tmp_path / "j"), 1, js)
    tck.save_checkpoint(str(tmp_path / "t"), 1, ts)
    mj, mt = (json.load(open(tmp_path / d / "step_000000001" /
                             "MANIFEST.json")) for d in ("j", "t"))
    assert mj["n_leaves"] == mt["n_leaves"]
    for k, meta in mj["leaves"].items():
        assert mt["leaves"][k] == meta, k


def test_checksum_in_chunks_equals_the_byte_sum(monkeypatch):
    """The chunked sum (no uint64 copy of the leaf) is JAX's
    ``_np_checksum`` across chunk edges, for every dtype."""
    monkeypatch.setattr(tckpt, "_CHUNK", 1000)
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal(12_345).astype(np.float32),
                rng.integers(-128, 128, 4099).astype(np.int8),
                np.asarray(rng.standard_normal(3001), jnp.bfloat16),
                np.array(2 ** 31 - 2, np.int32)):
        assert tckpt._np_checksum(arr) == jck.ckpt._np_checksum(arr)


def test_roundtrip_and_resume(tmp_path):
    base = str(tmp_path / "ck")
    st = _small()
    tck.save_checkpoint(base, 5, st)
    assert tck.latest_step(base) == 5
    back = tck.load_checkpoint(base, 5, st)
    with np.load(os.path.join(base, "step_000000005",
                              "shard_00000.npz")) as z:
        assert [z[k].shape for k in z.files] == [(6,), (4, 6), ()]
    assert torch.equal(back["params"]["w"], st["params"]["w"])
    assert back["params"]["b"].dtype == torch.bfloat16
    assert back["step"].shape == ()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_detects_corruption_and_falls_back(tmp_path, writer):
    base = str(tmp_path / "ck")
    for s in (1, 2):
        if writer == "port":
            tck.save_checkpoint(base, s, _small())
        else:
            jck.save_checkpoint(base, s, _j_small())
    # flip a byte in the newest shard (silent data corruption in storage)
    shard = os.path.join(base, "step_000000002", "shard_00000.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(shard, "wb").write(bytes(data))
    with pytest.raises((tck.CheckpointCorruption, Exception)):
        tck.load_checkpoint(base, 2, _small())
    restored, step = tck.CheckpointManager(base).restore_latest(_small())
    assert step == 1                    # fell back past the corrupt step
    assert not os.path.exists(os.path.join(base, "step_000000002"))
    assert torch.equal(restored["params"]["w"], _small()["params"]["w"])


def test_checksum_mismatch_raises_corruption(tmp_path):
    """A flip inside a leaf's bytes that the zip CRC does not see (the
    manifest checksum rewritten wrong) raises CheckpointCorruption."""
    base = str(tmp_path / "ck")
    tck.save_checkpoint(base, 1, _small())
    path = os.path.join(base, "step_000000001", "MANIFEST.json")
    man = json.load(open(path))
    man["leaves"]["a1"]["checksum"] += 1
    json.dump(man, open(path, "w"))
    with pytest.raises(tck.CheckpointCorruption, match="a1"):
        tck.load_checkpoint(base, 1, _small())
    with pytest.raises(tck.CheckpointCorruption, match="all checkpoints"):
        tck.CheckpointManager(base).restore_latest(_small())


def test_torn_write_ignored(tmp_path):
    base = str(tmp_path / "ck")
    tck.save_checkpoint(base, 1, _small())
    os.makedirs(os.path.join(base, "step_000000009"))   # no COMMIT
    assert tck.latest_step(base) == 1
    assert jck.latest_step(base) == 1


def test_manager_gc_and_async_snapshot(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_last=2, save_every=1)
    st = _small()
    for s in range(1, 6):
        mgr.maybe_save(s, st)
        # the snapshot is taken before maybe_save returns: a later change
        # of the caller's state is not what step s holds
        st = {**st, "step": st["step"] + 1}
    mgr.wait()
    mgr._gc()
    steps = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step_") and not n.endswith(".tmp"))
    assert steps == ["step_000000004", "step_000000005"]
    back, step = mgr.restore_latest(_small())
    assert step == 5 and int(back["step"]) == 4
    every3 = tck.CheckpointManager(str(tmp_path / "e3"), save_every=3)
    assert not every3.maybe_save(7, st)
    assert every3.maybe_save(7, st, force=True) and every3.maybe_save(9, st)
    every3.wait()
    assert tck.latest_step(str(tmp_path / "e3")) == 9


def test_leaf_count_mismatch_is_refused(tmp_path):
    base = str(tmp_path / "ck")
    tck.save_checkpoint(base, 1, _small())
    with pytest.raises(ValueError, match="leaves"):
        tck.load_checkpoint(base, 1, {"step": torch.zeros(())})


def test_a_failed_write_surfaces_on_wait(tmp_path, monkeypatch):
    """The writer fails mid-save: the caller's copies still finish, the
    step is not committed, and the error is raised by the next wait()."""
    def broken(path, named):
        next(iter(named))
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_savez", broken)
    mgr = tck.CheckpointManager(str(tmp_path), save_every=1)
    big = {f"l{i}": torch.full((64,), float(i)) for i in range(6)}
    assert mgr.maybe_save(1, big)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert tck.latest_step(str(tmp_path)) is None
