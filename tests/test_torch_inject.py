"""The port's fault injection against the JAX package's ``core/inject.py``.

Bit bands, bit flips and the victim choice must equal the JAX package's
on the same inputs.  The random draws come from another generator, so
for them the tests check what a draw must satisfy (distinct elements,
bits inside the band, never a dead lane of a packed weight), not the
draws themselves.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dlrm import EXTRAS as J_EXTRAS  # noqa: E402
from repro.configs.reduce import small_arch  # noqa: E402
from repro.core import inject as j_inj  # noqa: E402
from repro.models import rwkv as j_rwkv  # noqa: E402
from repro.models.dlrm import init_dlrm as j_init_dlrm  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.core import LANE, pack_encoded_b  # noqa: E402
from repro_torch.core import inject as t_inj  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

_DTYPES = ["int8", "uint8", "int16", "int32", "float32", "bfloat16",
           "float16"]
_BANDS = ["all", "low", "significant", "sign", "mantissa",
          "high_mantissa", "exponent", "nonsense"]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_bit_band_equals_jax(dtype):
    for band in _BANDS:
        for t_dtype in (dtype, getattr(torch, dtype)):
            try:
                want = j_inj.bit_band(jnp.dtype(dtype), band)
            except KeyError:
                with pytest.raises(KeyError, match="no bit band"):
                    t_inj.bit_band(t_dtype, band)
                continue
            assert t_inj.bit_band(t_dtype, band) == tuple(want), (dtype,
                                                                 band)


_FLIP_CASES = {
    "int8": (np.int8, jnp.int8, torch.int8),
    "uint8": (np.uint8, jnp.uint8, torch.uint8),
    "int32": (np.int32, jnp.int32, torch.int32),
    "float32": (np.float32, jnp.float32, torch.float32),
    "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
}


def _bits_of(x):
    """A tensor's bit patterns as numpy (bf16 through its int16 view)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy().view({1: np.uint8, 4: np.uint32}[x.element_size()])


def _jax_bits(y):
    y = np.asarray(y)
    if y.dtype == jnp.bfloat16:
        return y.view(np.int16)
    return y.view({1: np.uint8, 4: np.uint32}[y.dtype.itemsize])


@pytest.mark.parametrize("name", sorted(_FLIP_CASES))
def test_flip_bit_bit_exact_against_jax(name):
    np_dt, j_dt, t_dt = _FLIP_CASES[name]
    rng = np.random.default_rng(3)
    if name in ("float32", "bfloat16"):
        base = rng.standard_normal((6, 7)).astype(np.float32)
    else:
        info = np.iinfo(np_dt)
        base = rng.integers(info.min, info.max, (6, 7), endpoint=True,
                            dtype=np_dt)
    jx = jnp.asarray(base, j_dt)
    tx = torch.from_numpy(base).to(t_dt)
    nbits = tx.element_size() * 8
    coords = [(int(i), int(b)) for i, b in zip(
        rng.integers(0, tx.numel(), 24), rng.integers(0, nbits, 24))]
    coords += [(0, 0), (41, nbits - 1), (17, nbits - 1)]
    for idx, bit in coords:
        want = j_inj.flip_bit(jx, jnp.int32(idx), jnp.int32(bit))
        got = t_inj.flip_bit(tx, idx, bit)
        np.testing.assert_array_equal(_bits_of(got), _jax_bits(want))
        # in place, and back: the same bit flipped again restores it
        y = tx.clone()
        t_inj.flip_bit_(y, idx, bit)
        np.testing.assert_array_equal(_bits_of(y), _bits_of(got))
        t_inj.flip_bit_(y, idx, bit)
        np.testing.assert_array_equal(_bits_of(y), _bits_of(tx))
    with pytest.raises(IndexError):
        t_inj.flip_bit_(tx, tx.numel(), 0)
    with pytest.raises(ValueError):
        t_inj.flip_bit_(tx, 0, nbits)


def test_random_bitflip_live_skips_the_dead_lanes():
    b = torch.from_numpy(np.random.default_rng(0).integers(
        -127, 128, (3, 40, 24)).astype(np.int8))
    leaf = torch.stack([pack_encoded_b(x) for x in b])     # [3, 40, 152]
    last = leaf.shape[-1]
    gen = torch.Generator().manual_seed(0)
    cols, bits = set(), set()
    for _ in range(600):
        idx, bit = t_inj.draw_bitflip_live(gen, leaf,
                                           "layers.cm.wv.w_packed", (4, 8))
        cols.add(idx % last)
        bits.add(bit)
        assert 4 <= bit < 8
    # the weight block and the checksum column, never lanes 1..127
    assert cols == set(range(24 + 1))
    assert bits == {4, 5, 6, 7}
    out = t_inj.random_bitflip_live(gen, leaf, "x.w_packed")
    diff = (out != leaf).nonzero()
    assert diff.shape[0] == 1 and int(diff[0, -1]) <= 24
    # any other leaf: the plain model-1 flip over the whole leaf
    lanes = set()
    for _ in range(400):
        idx, _ = t_inj.draw_bitflip_live(gen, leaf, "tables.table")
        lanes.add(idx % last)
    assert max(lanes) > 24 + LANE // 2


def test_random_bitflips_distinct_and_inside_the_band():
    x = torch.zeros((5, 9), dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    for k in (1, 2, 7, 45):
        for _ in range(20):
            flips = t_inj.draw_bitflips(gen, x, k, (16, 32))
            idxs = [i for i, _ in flips]
            assert len(set(idxs)) == k
            assert all(0 <= i < 45 and 16 <= b < 32 for i, b in flips)
        y = t_inj.random_bitflips(gen, x, k, (16, 32))
        assert int((y != 0).sum()) == k
    with pytest.raises(ValueError):
        t_inj.draw_bitflips(gen, x, 46)
    y = t_inj.random_bitflip_band(gen, torch.zeros(8, dtype=torch.int8),
                                  "sign")
    assert y.tolist().count(-128) == 1


def test_random_value_wraps_a_32_bit_draw_into_the_signed_range():
    assert t_inj.wrap_signed(0xFFFFFFFF, 32) == -1
    assert t_inj.wrap_signed(0x80000000, 32) == -2**31
    assert t_inj.wrap_signed(0x1FF, 8) == -1
    assert t_inj.wrap_signed(0x7F, 8) == 127
    gen = torch.Generator().manual_seed(2)
    for dt in (torch.int8, torch.int32, torch.float32, torch.bfloat16):
        x = torch.zeros(64, dtype=dt)
        for _ in range(20):
            y = t_inj.random_value(gen, x)
            assert int((t_inj.signed_view(y) != 0).sum()) <= 1
    seen = {t_inj.draw_value(gen, torch.zeros(4, dtype=torch.int32))[1] < 0
            for _ in range(64)}
    assert seen == {True, False}


def _same_victims(j_tree, t_tree, patterns):
    assert [p for p, _ in t_inj.leaf_paths(t_tree)] == \
        [p for p, _ in j_inj.leaf_paths(j_tree)]
    for pat in patterns:
        assert t_inj.victim_leaf_index(t_tree, pat) == \
            j_inj.victim_leaf_index(j_tree, pat), pat
        assert t_inj.victim_leaf_index(t_tree, pat, prefer_int8=False) == \
            j_inj.victim_leaf_index(j_tree, pat, prefer_int8=False), pat
    with pytest.raises(ValueError, match="matches no leaf"):
        t_inj.victim_leaf_index(t_tree, "no.such.leaf")


def test_victims_equal_jax_on_the_smoke_dlrm():
    ex = dataclasses.replace(J_EXTRAS, table_rows=512, n_tables=4,
                             emb_dim=32, bottom_mlp=(64, 32),
                             top_mlp=(64, 32, 1))
    j_tree = values_of(jax.jit(functools.partial(
        j_init_dlrm, ex=ex, quant=True))(jax.random.key(0)))
    t_tree = from_jax(jax.tree.map(np.asarray, j_tree), device="cpu")
    _same_victims(j_tree, t_tree, [None, "tables", "top.0", "bottom.1",
                                   "alpha"])


def test_victims_equal_jax_on_the_smoke_rwkv():
    cfg = small_arch("rwkv6-1.6b")
    j_tree = values_of(jax.jit(lambda k: j_rwkv.init_rwkv(
        k, cfg, quant=True))(jax.random.key(0)))
    t_tree = from_jax(jax.tree.map(np.asarray, j_tree), device="cpu")
    _same_victims(j_tree, t_tree, [None, "embed", "cm.wv", "tm.w*",
                                   "head", "ln_x"])


def test_flip_bit_in_leaf_and_campaign():
    tree = {"b": [torch.zeros(3, dtype=torch.int8)],
            "a": torch.zeros((40, 50), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(4)
    bad, path = t_inj.flip_bit_in_leaf(tree, gen)
    assert path in ("['a']", "['b'][0]")
    changed = [int((x != 0).sum()) for x in (bad["a"], bad["b"][0])]
    assert sorted(changed) == [0, 1]
    assert int((tree["a"] != 0).sum()) == 0           # the input is intact

    x = torch.zeros(16, dtype=torch.int8)

    def detected(g):
        return bool((t_inj.random_bitflip(g, x) != 0).any())

    assert int(t_inj.campaign(detected, gen, 12)) == 12
