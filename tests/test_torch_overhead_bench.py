"""The port's overhead benchmarks (``repro_torch.benchmarks``) on the CPU,
where they run the plain versions: their columns, the bit-exactness each
cell holds, the paper's analytic models, the byte arithmetic from the
shapes, the alternating rounds, and the unprotected instances' launch
plans and plain dispatch.  No time is checked: a CPU time is no device
metric."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import eb_overhead, gemm_overhead  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.core import LANE, abft_qgemm_packed  # noqa: E402
from repro_torch.core import embedding_bag, pack_encoded_b  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.abft_qgemm import launch_plan  # noqa: E402


def test_gemm_rows_on_the_cpu():
    shapes = list(common.GEMM_SHAPES[::4])
    rows = gemm_overhead.run("cpu", quick=True)
    assert [r["shape"] for r in rows] == shapes
    for r, (m, n, k) in zip(rows, shapes):
        assert r["exact"] and r["copies"] == 1 and not r["cold_in_hbm"]
        assert r["analytic"] == 1 / (2 * m) + 1 / n + 1 / (2 * k)
        assert r["extra_bytes"] == k + 4 * m
        assert r["unprotected_bytes"] == m * k + k * n + 4 * m * n
        assert r["extra_bytes_share"] == r["extra_bytes"] / \
            r["unprotected_bytes"]
        assert set(r["cold_ms"]) == {"unprotected", "abft", "abft+encode"}
        assert set(r["warm_ms"]) == {"unprotected", "abft"}
        for s in list(r["cold_ms"].values()) + [r["overhead_cold"]]:
            assert s["min"] <= s["median"] <= s["max"]
        assert r["library_ms"] is None
        t_bytes = r["unprotected_bytes"] / common.HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / common.INT8_OPS_PER_S * 1e3
        assert r["bound_ms"] == pytest.approx(max(t_bytes, t_ops))
        assert r["bound_by"] == ("bytes" if t_bytes >= t_ops
                                 else "operations")
    # the checksum column is a tile of its own where n is a multiple of
    # 128, and shares the last tile otherwise
    assert [r["mma_tiles"] for r in rows] == [
        {True: 5, False: 4}, {True: 3, False: 2}, {True: 2, False: 1},
        {True: 9, False: 8}, {True: 9, False: 8}, {True: 9, False: 8},
        {True: 7, False: 7}]
    assert rows[2]["checksum_tile_share"] == 1.0
    assert rows[-1]["checksum_tile_share"] == 0.0
    md = gemm_overhead.table(rows, "host")
    assert md.count("\n| ") == 1 + len(shapes)
    assert "1×512×13" in md and "host ms" in md


def test_eb_rows_on_the_cpu():
    rows = eb_overhead.run("cpu", quick=True)
    assert [(r["d"], r["mode"]) for r in rows] == [
        (32, "regular"), (32, "weighted"), (64, "regular"),
        (64, "weighted")]
    for r in rows:
        d, w = r["d"], r["mode"] == "weighted"
        assert r["exact"] and r["rows"] == 200_000
        assert r["analytic"] == 1 / d + 1 / (3 * 100)
        assert r["extra_bytes"] == 4 * 10 * 100 + 5 * 10 + 4
        assert r["unprotected_bytes"] == \
            1000 * (4 + d + 8 + 4 * w) + 4 * 10 * d
        assert r["overhead"]["min"] <= r["overhead"]["median"] \
            <= r["overhead"]["max"]
        assert r["bound_by"] == "bytes"
    assert "Table I" in eb_overhead.table(rows, "host")


def test_the_paper_models():
    # §IV-A1 at the paper's largest and smallest overheads, §V-C at d 128
    assert gemm_overhead.analytic(256, 1024, 1024) == pytest.approx(
        1 / 512 + 1 / 1024 + 1 / 2048)
    assert gemm_overhead.analytic(1, 512, 13) > 0.5
    assert eb_overhead.analytic(128) == pytest.approx(1 / 128 + 1 / 300)


class _Recorder:
    clock = "host"

    def __init__(self):
        self.order = []

    def ms(self, fn, n=1):
        self.order.append(fn())
        return float(len(self.order))


def test_rounds_alternate_and_overhead_is_per_round():
    rec = _Recorder()
    out = common.alternate(rec, {"a": lambda: "a", "b": lambda: "b"}, 1)
    assert common.ROUNDS == 5
    assert rec.order == ["a", "b", "b", "a", "a", "b", "b", "a", "a", "b"]
    assert out == {"a": [1.0, 4.0, 5.0, 8.0, 9.0],
                   "b": [2.0, 3.0, 6.0, 7.0, 10.0]}
    ov = common.overhead([2.0, 3.0, 6.0], [1.0, 2.0, 4.0])
    assert ov == {"median": 0.5, "min": 0.5, "max": 1.0}


def test_unprotected_plans_share_the_protected_split():
    for m, n, k in common.GEMM_SHAPES:
        p = launch_plan(m, k, n, protect=True)
        u = launch_plan(m, k, n, protect=False)
        assert u._replace(tiles_n=p.tiles_n) == p
        assert u.tiles_n == math.ceil(n / 128)
        assert p.tiles_n == math.ceil((n + 1) / 128)


def test_plain_dispatch_of_the_unprotected_ops(rng):
    a = torch.randint(0, 256, (5, 70), dtype=torch.uint8)
    bp = pack_encoded_b(torch.randint(-127, 128, (70, 33),
                                      dtype=torch.int8))
    assert torch.equal(kops.qgemm_unprotected(a, bp),
                       abft_qgemm_packed(a, bp).c)
    assert kops.qgemm_unprotected(a, bp).shape == (5, bp.shape[1] - LANE)
    with pytest.raises(ValueError, match="CUDA"):
        kops.qgemm_unprotected(a, bp, use_kernel=True)
    table = torch.randint(-128, 128, (2, 50, 16), dtype=torch.int8)
    al, be = torch.rand(2, 50), torch.rand(2, 50)
    idx = torch.randint(-1, 50, (2, 4, 6), dtype=torch.int32)
    want = torch.stack([embedding_bag(table[t], al[t], be[t], idx[t])
                        for t in range(2)])
    assert torch.equal(kops.embedding_bag_unprotected(table, al, be, idx),
                       want)
    with pytest.raises(ValueError, match="CUDA"):
        kops.embedding_bag_unprotected(table, al, be, idx, use_kernel=True)


def test_cli_on_the_cpu_writes_the_figures(tmp_path, capsys):
    assert bench_run.main(["--quick", "--device", "cpu",
                           "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Fig. 5" in out and "Table I" in out
    res = json.loads((tmp_path / "BENCH_overhead.json").read_text())
    assert res["device"] == {"platform": "cpu", "clock": "host"}
    assert res["rounds"] == common.ROUNDS
    assert len(res["gemm_overhead"]) == len(common.GEMM_SHAPES[::4])
    assert len(res["eb_overhead"]) == 4
    assert all(r["exact"] for r in res["gemm_overhead"]
               + res["eb_overhead"])


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_run.main(["--only", "eb_overhead"])
