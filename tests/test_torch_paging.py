"""The port's paged KV cache (``repro_torch.paging``) against the JAX
package's ``repro.paging`` on the same numpy inputs.

The host side (allocator, prefix tree, manager) is driven through the
operation sequences of ``tests/test_paging.py`` and through seeded random
sequences, with every return value and every piece of state (tables,
refcounts, ``stats()``) equal after each operation.  The device side:
every integer (codes, pagesums, recomputed sums, mismatch counts,
``pages_verified``) bit-exact, the affine parameters bit-exact (the JAX
functions run eagerly, where ``span / 255`` is the IEEE quotient, ROADMAP
§C5), and ``attend_paged``'s float32 output within 1e-5 of its scale
(float32 sums in another order than XLA's).  The port writes pools in
place, so each JAX result is compared with the port's pool after the
call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import paging as jp  # noqa: E402
from repro.core import abft_kvcache as jkv  # noqa: E402
from repro.paging.prefixtree import chunk_keys as j_chunk_keys  # noqa: E402
from repro.protect import protected_call as j_protected_call  # noqa: E402
from repro.protect.plan import ProtectionPlan as JPlan  # noqa: E402
from repro.protect.runtime import paged_kv_rule as j_paged_kv_rule  # noqa
from repro_torch import paging as tp  # noqa: E402
from repro_torch.core import abft_kvcache as tkv  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.paging.prefixtree import chunk_keys  # noqa: E402
from repro_torch.protect import ProtectionPlan, protected_call  # noqa: E402
from repro_torch.protect.runtime import paged_kv_rule  # noqa: E402

#: float32 attention sums in another order than XLA's
_ATTN_TOL = 1e-5


def test_public_names_are_the_jax_packages():
    assert tp.__all__ == jp.__all__
    for name in jp.__all__:
        assert hasattr(tp, name), name


# ------------------------------ allocator -----------------------------------

def _alloc_state(al):
    return (al.used, al.free_count, al.shared_count, al.high_water,
            dict(al._ref), list(al._free))


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_jax_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    t_al, j_al = tp.PageAllocator(6), jp.PageAllocator(6)
    for _ in range(200):
        live = sorted(j_al._ref)
        op = rng.integers(8)
        if op < 4:
            assert t_al.alloc() == j_al.alloc()
        elif op < 6 and live:
            pid = int(rng.choice(live))
            t_al.retain(pid)
            j_al.retain(pid)
        elif op < 7 and live:
            pid = int(rng.choice(live))
            assert t_al.release(pid) == j_al.release(pid)
        elif rng.integers(10) == 0:
            t_al.reset()
            j_al.reset()
        assert _alloc_state(t_al) == _alloc_state(j_al)
        assert [t_al.refcount(p) for p in range(7)] == \
            [j_al.refcount(p) for p in range(7)]


def test_allocator_scenarios_of_the_jax_tests():
    for al in (tp.PageAllocator(4), jp.PageAllocator(4)):
        a, b = al.alloc(), al.alloc()
        assert (a, b) == (0, 1) and al.high_water == 2
        al.retain(a)
        assert al.refcount(a) == 2 and al.shared_count == 1
        assert not al.release(a) and al.release(a)
        assert al.used == 1 and al.free_count == 3
    for al in (tp.PageAllocator(2), jp.PageAllocator(2)):
        assert al.alloc() is not None and al.alloc() is not None
        assert al.alloc() is None
        al.reset()
        assert al.used == 0 and al.free_count == 2 and al.high_water == 0
    with pytest.raises(ValueError, match="positive"):
        tp.PageAllocator(0)


# ------------------------------ prefix tree ---------------------------------

def _tree_state(tree):
    nodes = {pid: (n.key, n.parent.page_id if n.parent else None,
                   n.last_use, sorted(c.page_id for c in
                                      n.children.values()))
             for pid, n in tree._by_page.items()}
    return len(tree), tree._clock, nodes


@pytest.mark.parametrize("seed", range(4))
def test_prefix_tree_matches_jax_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    trees = (tp.PrefixTree(), jp.PrefixTree())
    next_pid = 0
    for _ in range(150):
        # prompts over a 3-token vocabulary share chunks often
        toks = rng.integers(0, 3, 4 * rng.integers(1, 5))
        keys = chunk_keys(toks, 4)
        assert keys == j_chunk_keys(toks, 4)
        op = rng.integers(5)
        if op < 2:
            got = [[n.page_id for n in tr.match(keys)] for tr in trees]
            assert got[0] == got[1]
        elif op < 4:
            hits = [tr.match(keys) for tr in trees]
            if len(hits[0]) < len(keys):
                k = keys[len(hits[0])]
                for tr, h in zip(trees, hits):
                    tr.insert(h[-1] if h else None, k, next_pid)
                next_pid += 1
        elif rng.integers(2) and len(trees[1]):
            pid = int(rng.choice(sorted(trees[1]._by_page)))
            assert sorted(trees[0].evict_page(pid)) == \
                sorted(trees[1].evict_page(pid))
        else:
            assert trees[0].evict_lru() == trees[1].evict_lru()
        assert _tree_state(trees[0]) == _tree_state(trees[1])


def test_chunk_keys_match_jax():
    for seed in range(3):
        toks = np.random.default_rng(seed).integers(0, 128256, 37)
        for p in (1, 4, 8, 16):
            assert chunk_keys(toks, p) == j_chunk_keys(toks, p)


# ------------------------------ manager -------------------------------------

def _mgr_state(m):
    return (m.table.tolist(), [list(x) for x in m._prompt_pages],
            [list(x) for x in m._tail_pages], list(m.prompt_chunks),
            m.stats(), _alloc_state(m.alloc), _tree_state(m.tree))


def _plan_fields(plan):
    ids = None if plan.page_ids is None else plan.page_ids.tolist()
    return (plan.ok, plan.bucket, ids, plan.shared_pages, plan.new_pages)


def _both(n_pages, n_slots, max_pages, p=4):
    return tuple(mod.PagedKVManager(mod.PagingConfig(page_size=p,
                                                     n_pages=n_pages),
                                    n_slots, max_pages) for mod in (tp, jp))


def _drive(mgrs, ops):
    """Run (method, *args) operations on both managers; every result and
    the whole state equal after each."""
    for name, *args in ops:
        got = [getattr(m, name)(*args) for m in mgrs]
        if name in ("admit", "readmit"):
            got = [_plan_fields(g) for g in got]
        assert got[0] == got[1], (name, args)
        assert _mgr_state(mgrs[0]) == _mgr_state(mgrs[1]), (name, args)


def _toks(n, base=0):
    return base + np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("scenario", [
    "admit_share_retire", "decode_page_readmit", "rollback", "lru"])
def test_manager_scenarios_of_the_jax_tests(scenario):
    if scenario == "admit_share_retire":
        mgrs = _both(12, 2, 6)
        ops = [("admit", 0, _toks(12)), ("admit", 1, _toks(12)),
               ("retire", 0), ("admit", 0, _toks(12))]
    elif scenario == "decode_page_readmit":
        mgrs = _both(12, 2, 6)
        ops = [("admit", 0, _toks(8)), ("decode_page", 0, 2),
               ("evict_corrupt", 0, 0), ("release_prompt", 0),
               ("readmit", 0, _toks(8)), ("evict_corrupt", 0, 2)]
    elif scenario == "rollback":
        mgrs = _both(4, 2, 8)
        ops = [("admit", 0, _toks(12)), ("admit", 1, _toks(20, 100))]
    else:
        mgrs = _both(4, 2, 4)
        ops = [("admit", 0, _toks(12)), ("retire", 0),
               ("admit", 1, _toks(12, 500))]
    _drive(mgrs, ops)
    st = mgrs[0].stats()
    if scenario == "rollback":
        assert not mgrs[0].admit(1, _toks(20, 100)).ok
    if scenario == "lru":
        assert st["pages_resident"] == 4 and st["page_evictions"] >= 2
    if scenario == "decode_page_readmit":
        assert st["page_rebuilds"] == 1


@pytest.mark.parametrize("seed", range(4))
def test_manager_matches_jax_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    n_slots, p = 3, 4
    mgrs = _both(9, n_slots, 5, p)
    sys_prompt = rng.integers(0, 50, 8)
    buckets = [0] * n_slots
    for _ in range(120):
        slot = int(rng.integers(n_slots))
        op = rng.integers(6)
        if op < 2:
            n = 4 * int(rng.integers(1, 5))
            toks = np.concatenate([sys_prompt, rng.integers(0, 3, n)])[:n]
            _drive(mgrs, [("admit", slot, toks)])
            buckets[slot] = n
        elif op == 2:
            _drive(mgrs, [("decode_page", slot, int(rng.integers(5)))])
        elif op == 3:
            _drive(mgrs, [("retire", slot)])
        elif op == 4:
            _drive(mgrs, [("evict_corrupt", slot, int(rng.integers(5)))])
        elif buckets[slot]:
            toks = np.concatenate([sys_prompt, np.zeros(16, np.int64)])
            _drive(mgrs, [("release_prompt", slot),
                          ("readmit", slot, toks[:buckets[slot]])])
        if rng.integers(40) == 0:
            _drive(mgrs, [("reset",)])
    assert mgrs[0].prefix_hit_rate == mgrs[1].prefix_hit_rate


def test_paging_config_and_admit_plan_match_jax():
    assert tp.PagingConfig().to_dict() == jp.PagingConfig().to_dict()
    plan = tp.AdmitPlan(ok=True, bucket=16, shared_pages=1, new_pages=3)
    assert plan.tokens(4) == jp.AdmitPlan(
        ok=True, bucket=16, shared_pages=1, new_pages=3).tokens(4)


# ------------------------------ page pools ----------------------------------

def _t(x):
    """A JAX array (or tree of them) as writable CPU torch tensors."""
    if isinstance(x, tuple):
        return type(x)(*(_t(v) for v in x))
    return torch.from_numpy(np.array(x))


def _tpool(jpool):
    return tp.PagedKV(*(_t(v) for v in jpool))


def _tquant(jq):
    return tkv.QuantKV(*(_t(v) for v in jq))


def _equal_pool(tpool, jpool, fields=tp.PagedKV._fields):
    for f in fields:
        got, want = getattr(tpool, f).numpy(), np.asarray(getattr(jpool, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _scale_rows(rng, shape):
    return (rng.standard_normal(shape)
            * 10 ** rng.uniform(-2, 1)).astype(np.float32)


def test_paged_pool_matches_jax():
    for lead in (0, 3):
        _equal_pool(tp.paged_pool(7, 2, 4, 8, 3, 5, n_layers=lead,
                                  device="cpu"),
                    jp.paged_pool(7, 2, 4, 8, 3, 5, n_layers=lead))


def _packed(rng, *, ell=2, kv=2, p=4, dh=8, nc=3, n_pages=8, n_slots=2,
            max_pages=6, ids=None, quant=False):
    """A JAX pool with one prompt packed, and the port's from the same
    zero pool, packed the same way (sentinel ids skipped)."""
    ids = np.arange(nc, dtype=np.int32) if ids is None else ids
    src = _scale_rows(rng, (ell, 1, kv, nc * p, dh))
    j_src = jnp.asarray(src)
    t_src = torch.from_numpy(src)
    if quant:
        j_src = jkv.quantize_kv_rows(j_src)
        t_src = _tquant(j_src)
    j0 = jp.paged_pool(n_pages, kv, p, dh, n_slots, max_pages, n_layers=ell)
    jpool = jp.pack_prompt_pages(j0, j_src, jnp.asarray(ids))
    tpool = _tpool(j0)
    out = tp.pack_prompt_pages(tpool, t_src, ids)
    assert out is tpool                                # written in place
    return tpool, jpool


@pytest.mark.parametrize("quant", [False, True])
def test_pack_prompt_pages_bit_exact_with_sentinels(quant):
    rng = np.random.default_rng(0)
    n_pages = 8
    # scrambled ids; chunk 1 is already resident (sentinel): skipped
    ids = np.array([5, n_pages, 7, 0], np.int32)
    tpool, jpool = _packed(rng, nc=4, n_pages=n_pages, ids=ids,
                           quant=quant)
    _equal_pool(tpool, jpool)
    # no page besides the kept ones was written
    assert not tpool.q[:, [1, 2, 3, 4, 6]].any()
    assert int(tpool.table.ne(-1).sum()) == 0          # table untouched


def test_reset_pages_bit_exact_with_sentinels():
    rng = np.random.default_rng(1)
    tpool, jpool = _packed(rng, nc=5)
    vec = np.array([2, 8, 4, 8], np.int32)             # 8 = sentinel
    _equal_pool(tp.reset_pages(tpool, vec),
                jp.reset_pages(jpool, jnp.asarray(vec)))
    assert tpool.q[:, [0, 1, 3]].any()


def _layer(tree, i=0):
    return type(tree)(*(v[i] for v in tree))


def _append_case(case):
    """(per-layer JAX pool, table, pos): slot 0's prompt on pages 3, 1, 2,
    the other pages zero, and the slot rows of each case."""
    rng = np.random.default_rng(2)
    _, jpool = _packed(rng, nc=3, n_pages=8,
                       ids=np.array([3, 1, 2], np.int32))
    j0 = _layer(jpool)
    tbl = np.full((4, 6), -1, np.int32)
    tbl[0, :3] = [3, 1, 2]
    if case == "mapped_and_unmapped":
        tbl[0, 3] = 4                     # slot 0's fresh tail page
        pos = [12, 12, 5, 0]              # slots 1-3 unmapped: dropped
    elif case == "dropped_on_a_kept_page":
        tbl[0, 3] = 0                     # the kept write: page 0, row 0
        pos = [12, 0, 4, 8]               # dropped rows that clip there
    elif case == "last_page_kept":
        tbl[0, 3] = 7                     # page n_pages - 1 takes a write
        tbl[2, 1] = 6
        pos = [13, 3, 7, 13]
    elif case == "none_kept":
        pos = [40, 40, 40, 40]            # all slots unmapped there
        tbl[0, :] = -1
    else:                                 # positions past the table clip
        tbl[0, 5] = 4
        pos = [44, 60, 2, 3]
    return j0._replace(table=jnp.asarray(tbl)), np.asarray(pos, np.int32)


@pytest.mark.parametrize("case", [
    "mapped_and_unmapped", "dropped_on_a_kept_page", "last_page_kept",
    "none_kept", "past_the_table"])
def test_paged_append_bit_exact_and_drops_unmapped(case):
    j0, pos = _append_case(case)
    new = _scale_rows(np.random.default_rng(3), (4, 2, 8))
    want = jp.paged_append(j0, jnp.asarray(pos), jnp.asarray(new))
    t0 = _tpool(j0)
    before = tp.PagedKV(*(v.clone() for v in t0))
    got = tp.paged_append(t0, torch.from_numpy(pos), torch.from_numpy(new))
    assert got is t0
    _equal_pool(got, want)
    # the pagesum of every page is still the fold of its codes
    touched = torch.tensor([12, 13, 13, 13], dtype=torch.int32)
    j_err = jp.page_errors(want, jnp.asarray(touched.numpy()))
    t_err = tp.page_errors(got, touched)
    np.testing.assert_array_equal(t_err.numpy(), np.asarray(j_err))
    assert int(t_err.sum()) == 0
    if case == "none_kept":
        _equal_pool(got, before)


def _flipped(tpool, jpool, idx, mask):
    q = np.array(jpool.q)
    q[idx] ^= mask
    tq = tpool.q.clone()
    tq[idx] ^= mask
    return tpool._replace(q=tq), jpool._replace(q=jnp.asarray(q))


def _with_table(tpool, jpool, tbl):
    ell = jpool.q.shape[0]
    jt = jnp.broadcast_to(jnp.asarray(tbl), (ell,) + tbl.shape)
    return (tpool._replace(table=torch.from_numpy(np.array(jt))),
            jpool._replace(table=jt))


@pytest.mark.parametrize("pos", [[11, 0], [5, 0], [8, 3], [2, 30]])
def test_page_errors_and_scrub_bit_exact_with_the_frontier(pos):
    rng = np.random.default_rng(4)
    tpool, jpool = _packed(rng, nc=3)
    tbl = np.full((2, 6), -1, np.int32)
    tbl[0, :3] = [0, 1, 2]
    tbl[1, [0, 2]] = [2, 1]               # a hole at chunk 1
    tpool, jpool = _with_table(tpool, jpool, tbl)
    tpool, jpool = _flipped(tpool, jpool, (1, 2, 0, 1, 3), 0x08)
    tpool, jpool = _flipped(tpool, jpool, (0, 1, 1, 0, 0), -128)
    p = np.asarray(pos, np.int32)
    per_layer = jax.vmap(jp.page_errors, in_axes=(0, None))
    np.testing.assert_array_equal(
        tp.page_errors(tpool, torch.from_numpy(p)).numpy(),
        np.asarray(per_layer(jpool, jnp.asarray(p))))
    for i in range(2):
        np.testing.assert_array_equal(
            tp.page_errors(_layer(tpool, i), torch.from_numpy(p)).numpy(),
            np.asarray(jp.page_errors(_layer(jpool, i), jnp.asarray(p))))
    v_t, v_j = _flipped(tpool, jpool, (0, 0, 1, 2, 5), 0x01)
    got = tp.scrub_cache({"attn": {"k": tpool, "v": v_t}},
                         torch.from_numpy(p))
    want = jp.scrub_cache({"attn": {"k": jpool, "v": v_j}}, jnp.asarray(p))
    for name in ("k", "v"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def _attend_pools(seed, *, n_slots=3, kv=2, p=4, dh=16, n_pages=10, mp=5):
    """Random per-layer K and V pools (JAX) with consistent pagesums and
    a table with shared, private and unmapped entries."""
    rng = np.random.default_rng(seed)
    pools = []
    for _ in range(2):
        src = _scale_rows(rng, (1, 1, kv, n_pages * p, dh))
        j0 = jp.paged_pool(n_pages, kv, p, dh, n_slots, mp, n_layers=1)
        pools.append(_layer(jp.pack_prompt_pages(
            j0, jnp.asarray(src), jnp.arange(n_pages, dtype=jnp.int32))))
    tbl = np.full((n_slots, mp), -1, np.int32)
    tbl[0, :4] = [3, 1, 4, 0]
    tbl[1, :3] = [3, 1, 7]                 # shares pages 3 and 1
    tbl[2, [0, 2, 3]] = [9, 5, 6]          # a hole at chunk 1
    return [pl._replace(table=jnp.asarray(tbl)) for pl in pools]


@pytest.mark.parametrize("window,prefix_global", [
    (None, 0), (5, 0), (5, 4)])
def test_attend_paged_matches_jax(window, prefix_global):
    jk, jv = _attend_pools(5)
    n_heads, kv, dh = 4, 2, 16
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, n_heads, dh)).astype(np.float32)
    pos = np.array([14, 9, 13], np.int32)
    jk_bad = jk._replace(q=jk.q.at[1, 0, 2, 3].set(jk.q[1, 0, 2, 3] ^ 16))
    jv_bad = jv._replace(q=jv.q.at[7, 1, 0, 0].set(jv.q[7, 1, 0, 0] ^ 1))
    for kpool, vpool in ((jk, jv), (jk_bad, jv_bad)):
        for verify in (True, False):
            want = jp.attend_paged(jnp.asarray(q), kpool, vpool,
                                   jnp.asarray(pos), n_heads=n_heads,
                                   n_kv=kv, verify=verify, window=window,
                                   prefix_global=prefix_global)
            got = tp.attend_paged(torch.from_numpy(q), _tpool(kpool),
                                  _tpool(vpool), torch.from_numpy(pos),
                                  n_heads=n_heads, n_kv=kv, verify=verify,
                                  window=window,
                                  prefix_global=prefix_global)
            w0 = np.asarray(want[0])
            assert got[0].dtype == torch.float32
            assert np.abs(got[0].numpy() - w0).max() <= \
                _ATTN_TOL * np.abs(w0).max()
            for g, w in zip(got[1:], want[1:]):
                assert g.dtype == torch.int32 and int(g) == int(w)
    # the flipped K page is shared by slots 0 and 1 and the V page read by
    # slot 1 only: 2 + 1 flags; touched pages 4 + 3 + 3 (hole skipped)
    assert (int(got[1]), int(got[2])) == (0, 0)
    _, errs, pages = tp.attend_paged(
        torch.from_numpy(q), _tpool(jk_bad), _tpool(jv_bad),
        torch.from_numpy(pos), n_heads=n_heads, n_kv=kv)
    assert (int(errs), int(pages)) == (3, 2 * 10)


def test_attend_paged_equals_contiguous_attend_quantized():
    rng = np.random.default_rng(3)
    kv, p, dh, nc, n_heads = 2, 4, 16, 4, 4
    s = nc * p
    kf = rng.standard_normal((1, 1, kv, s, dh)).astype(np.float32)
    vf = rng.standard_normal((1, 1, kv, s, dh)).astype(np.float32)
    ids = np.array([3, 1, 4, 0], np.int32)        # scrambled page order
    pk = tp.pack_prompt_pages(tp.paged_pool(8, kv, p, dh, 1, nc, n_layers=1,
                                            device="cpu"),
                              torch.from_numpy(kf), ids)
    pv = tp.pack_prompt_pages(tp.paged_pool(8, kv, p, dh, 1, nc, n_layers=1,
                                            device="cpu"),
                              torch.from_numpy(vf), ids)
    tbl = torch.from_numpy(ids)[None]
    q = torch.from_numpy(rng.standard_normal((1, n_heads, dh)).astype(
        np.float32))
    pos = torch.tensor([s - 2], dtype=torch.int32)
    out, errs, pages = tp.attend_paged(
        q, _layer(pk)._replace(table=tbl), _layer(pv)._replace(table=tbl),
        pos, n_heads=n_heads, n_kv=kv)
    assert int(errs) == 0 and int(pages) == 2 * nc
    ref, ref_errs = tkv.attend_quantized(
        q, tkv.quantize_kv_rows(torch.from_numpy(kf[:, 0])),
        tkv.quantize_kv_rows(torch.from_numpy(vf[:, 0])), pos,
        n_heads=n_heads, n_kv=kv)
    assert int(ref_errs) == 0
    assert torch.allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_pool_page_bytes_matches_jax():
    for lead in (0, 2):
        j = jp.paged_pool(6, 8, 16, 64, 4, 6, n_layers=lead)
        t = tp.paged_pool(6, 8, 16, 64, 4, 6, n_layers=lead, device="cpu")
        assert tp.pool_page_bytes(t) == jp.pool_page_bytes(j)
    # full-width Llama-3.2-1B at page 16: one page of both pools
    t = tp.paged_pool(2, 8, 16, 64, 4, 6, n_layers=16, device="cpu")
    assert 2 * tp.pool_page_bytes(t) == 295_936


def test_paged_pool_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.paged_pool(2, 1, 4, 8, 1, 2)


# ------------------------------ the adapter ---------------------------------

@pytest.mark.parametrize("plan_text", [
    "*:policy=log,kv_cache_paged:on", "*:policy=recompute,kv_cache_paged:on",
    "*:policy=log"])
def test_protected_call_counts_touched_pages_as_jax(plan_text):
    jk, jv = _attend_pools(7)
    jk = jk._replace(q=jk.q.at[4, 1, 0, 2].set(jk.q[4, 1, 0, 2] ^ 4))
    q = np.random.default_rng(8).standard_normal((3, 4, 16)).astype(
        np.float32)
    pos = np.array([15, 6, 12], np.int32)

    class JCtx:
        plan = JPlan.parse(plan_text)

    ctx = Ctx(quant=True, plan=ProtectionPlan.parse(plan_text))
    j_rule, t_rule = j_paged_kv_rule(JCtx()), paged_kv_rule(ctx)
    assert (t_rule.enabled, t_rule.policy) == (j_rule.enabled, "log")
    j_out, j_rep = j_protected_call(
        "kv_cache_paged", (jk, jv), jnp.asarray(q), jnp.asarray(pos),
        rule=j_rule, n_heads=4, n_kv=2)
    t_out, t_rep = protected_call(
        "kv_cache_paged", (_tpool(jk), _tpool(jv)), torch.from_numpy(q),
        torch.from_numpy(pos), rule=t_rule, n_heads=4, n_kv=2)
    jm, tm = j_rep.as_metrics(), t_rep.as_metrics()
    for key in ("abft/kv_cache_paged_checks", "abft/kv_cache_paged_errors",
                "abft/retries"):
        assert int(tm[key]) == int(jm[key]), key
    if t_rule.enabled:
        assert int(tm["abft/kv_cache_paged_checks"]) == 2 * 9
        assert int(tm["abft/kv_cache_paged_errors"]) == 1
    w = np.asarray(j_out)
    assert np.abs(t_out.numpy() - w).max() <= _ATTN_TOL * np.abs(w).max()
