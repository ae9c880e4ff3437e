"""The port's cost counter (``repro_torch.launch.costs``), its collective
stats and its roofline on the H100, case for case as
``tests/test_costs_analyzer.py`` holds the JAX package's HLO analyzer.

An eager program has no ``while`` body to multiply: its loops are Python
loops, every trip of which the counter sees, so the trip-count cases
hold the counter to the loop's product.  Everything runs on meta
tensors; the sharded case on a fake world of 4 ranks in this process.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.costs import (CostCounter, collective_link_bytes,  # noqa: E402
                                      count)
from repro_torch.launch.dryrun import fake_world, make_mesh  # noqa: E402
from repro_torch.launch.hlo import collective_stats  # noqa: E402


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_loop_free_counts_the_product_and_its_bytes():
    a, b = _meta(128, 256), _meta(256, 512)
    _, c = count(lambda: torch.tanh(a @ b))
    mine = c.result()
    assert mine["flops"] == pytest.approx(2 * 128 * 256 * 512, rel=0.02)
    # each op reads its operands and writes its result once
    mm = (128 * 256 + 256 * 512 + 128 * 512) * 4
    tanh = 2 * 128 * 512 * 4
    assert mine["bytes"] == mm + tanh
    assert not mine["flags"]


@pytest.mark.parametrize("L", [4, 8, 16])
def test_python_loop_counts_every_trip(L):
    x, ws = _meta(64, 64), _meta(L, 64, 64)

    def f():
        c = x
        for w in torch.unbind(ws):
            c = torch.tanh(c @ w)
        return torch.sum(c)

    _, c = count(f)
    assert c.result()["flops"] == pytest.approx(2 * 64 ** 3 * L, rel=0.02)
    assert not c.result()["flags"]


def test_nested_loops_multiply():
    x, ws = _meta(64, 64), _meta(8, 64, 64)

    def h():
        c = x
        for w in torch.unbind(ws):
            for _ in range(4):
                c = torch.tanh(c @ w)
        return torch.sum(c)

    _, c = count(h)
    assert c.result()["flops"] == pytest.approx(2 * 64 ** 3 * 8 * 4,
                                                rel=0.02)


def test_checkpointed_grad_counts_the_recompute():
    from torch.utils.checkpoint import checkpoint
    L = 8
    x, ws = _meta(64, 64), _meta(L, 64, 64, grad=True)

    def tr():
        c = x
        for w in torch.unbind(ws):
            c = checkpoint(lambda c_, w_: torch.tanh(c_ @ w_), c, w,
                           use_reentrant=False)
        return torch.autograd.grad(torch.sum(c), [ws])

    _, c = count(tr)
    # forward L products + per layer (recompute 1 + backward 2) = 4L,
    # less the input's gradient the first layer does not need
    assert c.result()["flops"] == pytest.approx(2 * 64 ** 3 * L * 4,
                                                rel=0.05)
    mem = c.memory()
    assert mem["peak_estimate_bytes"] > 0 and mem["breakdown"]


def test_int8_product_has_no_staging_copy():
    """The int8 product's float64 staging copies (the plain K1's exact
    product) are charged at the int8 operands' bytes, as JAX charges an
    int8 dot whose CPU lowering converts its operands."""
    from repro_torch.kernels.ref import int8_dot
    a = _meta(64, 512, dtype=torch.int8)
    b = _meta(512, 1024, dtype=torch.int8)
    _, c = count(int8_dot, a, b)
    staged = 64 * 512 * 8 + 512 * 1024 * 8     # float64 copies
    direct = 64 * 512 + 512 * 1024 + 64 * 1024 * 4
    assert c.result()["bytes"] < direct + staged / 2, (
        "the staging copies are charged")
    assert c.result()["flops"] == 2 * 64 * 512 * 1024


def test_collective_accounting_sharded():
    """y = x @ w with w's columns over a model axis of 4, gathered whole:
    one all-gather of y's bytes, ring link bytes 3/4 of them, a group on
    one host."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(4):
        mesh = make_mesh((4,), ("model",))
        x = DTensor.from_local(_meta(64, 128), mesh, [Replicate()],
                               run_check=False)
        w = DTensor.from_local(_meta(128, 64), mesh, [Shard(1)],
                               run_check=False, shape=(128, 256),
                               stride=(256, 1))
        with CostCounter() as c:
            y = (x @ w).redistribute(mesh, [Replicate()])
        assert tuple(y.shape) == (64, 256)
    r = c.result()
    raw = 64 * 256 * 4
    assert r["collectives"] == {"all-gather": {"count": 1.0,
                                               "bytes": float(raw)}}
    assert r["collective_raw_bytes"] == raw
    assert r["collective_link_bytes"] == raw * 3 / 4
    assert r["collective_link_bytes_host"] == raw * 3 / 4
    # the local product: rank 0's 64 of the 256 columns
    assert r["flops"] == 2 * 64 * 128 * 64
    stats = collective_stats(c.collective_log)
    assert stats == {"all-gather": {"count": 1, "bytes": raw},
                     "total": {"count": 1, "bytes": raw}}


def test_ring_link_bytes_are_jax_formula():
    raw = 1000.0
    assert collective_link_bytes("all-reduce", raw, 8) == 2 * raw * 7 / 8
    for kind in ("all-gather", "reduce-scatter", "all-to-all",
                 "collective-broadcast"):
        assert collective_link_bytes(kind, raw, 16) == raw * 15 / 16
    assert collective_link_bytes("collective-permute", raw, 4) == raw
    assert collective_link_bytes("all-reduce", raw, 1) == 0.0


def test_roofline_uses_the_h100_and_the_link_rule():
    cost = {"flops": 989e12, "bytes": 2 * 3.35e12,
            "collective_link_bytes": 450e9 + 3 * 50e9,
            "collective_link_bytes_host": 450e9}
    r = roofline.roofline_terms(cost, n_devices=256)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    # one second over NVLink within the host, three over the network
    assert r["collective_s"] == pytest.approx(4.0)
    assert r["dominant"] == "collective"
    assert r["step_lower_bound_s"] == pytest.approx(4.0)
    assert roofline.PEAK_FLOPS == common.BF16_OPS_PER_S == 989e12
    assert roofline.HBM_BW == common.HBM_BYTES_PER_S == 3.35e12
    assert (roofline.NVLINK_BW, roofline.NETWORK_BW) == (450e9, 50e9)
    # JAX's records carry no within-host share: all of it is network
    r = roofline.roofline_terms({"flops": 0.0, "bytes": 0.0,
                                 "collective_link_bytes": 50e9},
                                n_devices=256)
    assert r["collective_s"] == pytest.approx(1.0)


def test_a_group_across_hosts_takes_the_network():
    """A model axis of 16 ranks spans two 8-card hosts: its collectives'
    link bytes are not within one host."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(16):
        mesh = make_mesh((16,), ("model",))
        w = DTensor.from_local(_meta(8, 4), mesh, [Shard(0)],
                               run_check=False, shape=(128, 4),
                               stride=(4, 1))
        with CostCounter() as c:
            w.redistribute(mesh, [Replicate()])
    r = c.result()
    assert r["collective_link_bytes"] == 128 * 4 * 4 * 15 / 16
    assert r["collective_link_bytes_host"] == 0.0


def test_count_params_takes_the_moe_share():
    tree = {"embed": {"table": _meta(10, 4)},
            "layers": {"moe": {"up": {"w": _meta(2, 4, 8)}},
                       "attn": {"wq": {"w": _meta(4, 4)}}}}
    p = roofline.count_params(tree, active_moe=0.25)
    assert p == {"total": 40.0 + 64.0 + 16.0,
                 "active": 40.0 + 16.0 + 0.25 * 64.0}
    assert roofline.model_flops("train", 10.0, tokens=3) == 180.0
    assert roofline.model_flops("decode", 10.0, tokens=3) == 60.0


def test_inspect_cell_attributes_bytes_and_flops(capsys):
    """``inspect_cell`` on a full-width RWKV6 decode cell: per-device
    totals, then the top byte contributors by call path and op."""
    from repro_torch.launch import inspect_cell
    assert inspect_cell.main(["--arch", "rwkv6-1.6b", "--shape",
                              "decode_32k", "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-1.6b × decode_32k — per-device totals" in out
    rows = [ln for ln in out.splitlines() if ln.strip().endswith(
        tuple(f"aten.{op}" for op in ("mm", "bmm", "mul", "add", "sub",
                                      "exp", "div", "sum", "where", "cat",
                                      "remainder", "clamp", "round",
                                      "index", "embedding", "amax",
                                      "amin")))
            or "aten." in ln]
    assert len(rows) == 5
    assert not torch.distributed.is_initialized()


def test_roofline_table_rows(tmp_path, capsys):
    """The ABFT rows (three a Fig. 5 shape, K1's extra bytes
    ``gemm_overhead.extra_bytes``, the unfused path's product re-read)
    and the dry-run rows of a record directory."""
    import json
    from repro_torch.benchmarks import gemm_overhead, roofline_table
    rows = roofline_table.abft_rows()
    assert len(rows) == 3 * len(common.GEMM_SHAPES)
    for i in range(0, len(rows), 3):
        un, k1, unf = rows[i:i + 3]
        m, n, k = un["shape"]
        assert (un["instance"], k1["instance"], unf["instance"]) == \
            roofline_table.INSTANCES
        assert un["bytes"] == gemm_overhead.unprotected_bytes(m, n, k)
        assert k1["extra_bytes"] == gemm_overhead.extra_bytes(m, n, k)
        assert unf["extra_bytes"] == k1["extra_bytes"] + 4 * m * (n + 128)
        assert un["bound_ms"] <= k1["bound_ms"] <= unf["bound_ms"]
    rec = {"arch": "a", "shape": "s", "mesh": "pod16x16", "status": "ok",
           "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                        "collective_s": 0.5, "dominant": "memory"},
           "memory_per_device": {"peak_estimate_bytes": 2 * 2**30,
                                 "argument_bytes": 2**30},
           "model_vs_hlo": 0.5}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {**rec, "arch": "b", "status": "failed", "error": "E: refused"}))
    cells = roofline_table.dryrun_rows(roofline_table.load_cells(
        str(tmp_path)), 2**30)
    assert [c["status"] for c in cells] == ["ok", "failed"]
    assert cells[0]["fits"] is False and cells[0]["dominant"] == "memory"
    assert "OOM!" in roofline_table.dryrun_table(cells, 2**30, "1 GiB")
    assert roofline_table.main(["--art-dir", str(tmp_path), "--quick"]) == 0
    out = capsys.readouterr().out
    assert "ABFT implementation roofline" in out and "OOM!" not in out
