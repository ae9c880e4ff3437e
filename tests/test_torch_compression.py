"""The port's int8 error-feedback gradient compression and its mod-8191
checked reduction (``repro_torch.runtime.compression``) against the JAX
package's (``repro.runtime.compression``), on the CPU.

* q, the scale, the checksum and the residual equal JAX's run op by op
  bit for bit, and so do the reduction's sums and error counts, the
  mismatch branch included.  The residues are floor remainders
  (``torch.remainder``), as JAX's ``%``: non-negative for negative q.
* Under ``jax.jit`` XLA folds ``amax / 127`` into a multiply by the
  float32 reciprocal (ROADMAP §C5): the jitted scale is 1 ulp off in a
  few percent of leaves (9 of 200 here), and q with it.  The port takes
  the IEEE quotient, as JAX run op by op does.
* The collective branch runs over ``torch.distributed`` with two gloo
  ranks in a subprocess: the reduced payload is the ranks' sum, the
  additivity check passes, and one rank's flipped byte is caught after
  the reduction.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import compression as jc  # noqa: E402
from repro_torch.runtime import compression as tc  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _grads(rng, scale=1.0):
    return {"w": (rng.standard_normal((64, 48)) * scale).astype(np.float32),
            "b": (rng.standard_normal((48,)) * scale).astype(np.float32),
            "layers": {"m": (rng.standard_normal((2, 16, 24))
                             * scale * 1e-3).astype(np.float32)}}


def _eq(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = _tleaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _tleaves(tree):
    from repro_torch.core.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("n", [1, 1000, 262_176, 262_177, 600_001])
def test_mod_checksum_bit_exact(n):
    """Across the int32 chunk (2^31 - 1) // 8191 = 262,176 and with
    negative values: the port's residue sum equals JAX's chunked one."""
    rng = np.random.default_rng(n)
    x = rng.integers(-(2 ** 20), 2 ** 20, (n,), dtype=np.int32)
    with jax.disable_jit():
        want = int(jc._mod_checksum(jnp.asarray(x)))
    got = tc._mod_checksum(torch.from_numpy(x))
    assert got.dtype == torch.int32 and int(got) == want
    if n <= 1000:
        assert want == sum(int(v) % tc.MOD for v in x) % tc.MOD


def test_mod_checksum_negative_residues_are_floor_mod():
    q = torch.tensor([-1, -127, 127, 0, -8191, -8192], dtype=torch.int32)
    assert int(tc._mod_checksum(q)) == sum(int(v) % 8191
                                           for v in q.tolist()) % 8191
    with jax.disable_jit():
        assert int(jc._mod_checksum(jnp.asarray(q.numpy()))) == \
            int(tc._mod_checksum(q))


@pytest.mark.parametrize("scale", [1e-7, 1.0, 300.0])
def test_compress_grads_bit_exact_over_steps(scale):
    """Four steps of error feedback: q, scale, checksum and residual
    equal JAX's op by op each step."""
    rng = np.random.default_rng(int(scale * 1e7) % 1000)
    g0 = _grads(rng, scale)
    js = jc.init_compression(jax.tree.map(jnp.asarray, g0))
    ts = tc.init_compression(from_jax(g0, device="cpu"))
    for _ in range(4):
        g = _grads(rng, scale)
        with jax.disable_jit():
            jp, js = jc.compress_grads(jax.tree.map(jnp.asarray, g), js)
        tp, ts = tc.compress_grads(from_jax(g, device="cpu"), ts)
        for k in ("q", "scale", "checksum"):
            _eq(jp[k], tp[k])
        _eq(js.error, ts.error)
        assert isinstance(ts, tc.CompressionState)


def test_jit_folds_the_scale_division():
    """§C5: the jitted compress differs from the op-by-op one (and the
    port) in the scale of some leaves; op by op it never does."""
    rng = np.random.default_rng(5)
    jit_diff = port_diff = 0
    compress = jax.jit(jc.compress_grads)
    for _ in range(60):
        g = {"a": (rng.standard_normal((257, 33))
                   * 10.0 ** rng.uniform(-8, 3)).astype(np.float32)}
        st = jc.init_compression(g)
        with jax.disable_jit():
            p1, _ = jc.compress_grads(jax.tree.map(jnp.asarray, g), st)
        p2, _ = compress(jax.tree.map(jnp.asarray, g), st)
        p3, _ = tc.compress_grads(from_jax(g, device="cpu"),
                                  tc.init_compression(
                                      from_jax(g, device="cpu")))
        jit_diff += int(np.asarray(p1["scale"]["a"])
                        != np.asarray(p2["scale"]["a"]))
        port_diff += int(np.asarray(p1["scale"]["a"]).tobytes()
                         != p3["scale"]["a"].numpy().tobytes())
    assert port_diff == 0
    assert jit_diff > 0


@pytest.mark.parametrize("flip", [None, ("w", 5, 3), ("b", 0, 7),
                                  ("layers.m", 700, 0)])
def test_checked_psum_single_device_and_the_mismatch_branch(flip):
    """group=None: the verify-only path.  A byte of the payload flipped
    between the encode and the reduction is caught (one error a leaf),
    the summed q, scales and count equal JAX's."""
    rng = np.random.default_rng(6)
    g = _grads(rng)
    with jax.disable_jit():
        jp, _ = jc.compress_grads(jax.tree.map(jnp.asarray, g),
                                  jc.init_compression(g))
    tp, _ = tc.compress_grads(from_jax(g, device="cpu"),
                              tc.init_compression(from_jax(g, "cpu")))
    if flip is not None:
        path, idx, bit = flip
        keys = path.split(".")
        jq = jp["q"]
        for k in keys[:-1]:
            jq = jq[k]
        arr = np.asarray(jq[keys[-1]]).copy()
        arr.reshape(-1).view(np.uint8)[idx] ^= np.uint8(1 << bit)
        jq[keys[-1]] = jnp.asarray(arr)
        tq = tp["q"]
        for k in keys[:-1]:
            tq = tq[k]
        tq[keys[-1]].view(-1).view(torch.uint8)[idx] ^= (1 << bit)
    with jax.disable_jit():
        js, jsc, je = jc.checked_psum(jp, None)
        jv = jc.verify_payload(jp)
        jmean = jc.decompress_grads(js, jsc, 1)
    ts, tsc, te = tc.checked_psum(tp, None)
    _eq(js, ts)
    _eq(jsc, tsc)
    assert te.dtype == torch.int32
    assert int(te) == int(je) == int(tc.verify_payload(tp)) == int(jv) \
        == (0 if flip is None else 1)
    _eq(jmean, tc.decompress_grads(ts, tsc, 1))
    *_, local = tc.checked_psum_attributed(tp, None)
    assert int(local) == int(te)


def test_compressed_allreduce_and_error_feedback_converge():
    """The one-call path equals the staged one, and averaging the
    compressed grads over steps approaches the true mean (the residual
    carries the quantization error), as the JAX substrate test holds."""
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.standard_normal((64,))
                               .astype(np.float32))}
    state = tc.init_compression(g)
    acc = torch.zeros(64)
    for _ in range(50):
        mean, state, errs = tc.compressed_allreduce(g, state, None, 1)
        assert int(errs) == 0
        acc += mean["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(),
                               atol=2e-2)
    with jax.disable_jit():
        jm, _, je = jc.compressed_allreduce(
            {"w": jnp.asarray(g["w"].numpy())},
            jc.init_compression({"w": g["w"].numpy()}), None, 1)
    tm, _, te = tc.compressed_allreduce(g, tc.init_compression(g), None, 1)
    assert np.asarray(jm["w"]).tobytes() == tm["w"].numpy().tobytes()


_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.runtime import compression as tc


def grads(rank):
    rng = np.random.default_rng(100 + rank)
    return {"w": torch.from_numpy(rng.standard_normal((40, 24))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((24,))
                                  .astype(np.float32))}


def run(rank, port, flip, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    payload, _ = tc.compress_grads(grads(rank), tc.init_compression(
        grads(rank)))
    if flip and rank == 1:      # in transit: after the encode
        payload["q"]["w"].view(-1).view(torch.uint8)[7] ^= 1 << 4
    summed, scale_sum, errs, local = tc.checked_psum_attributed(
        payload, dist.group.WORLD)
    mine = {k: v.to(torch.int32) for k, v in payload["q"].items()}
    torch.save({"summed": summed, "scale": scale_sum, "errs": int(errs),
                "local": int(local), "q": mine, "scale_in":
                payload["scale"]}, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    port, flip, out = int(sys.argv[1]), sys.argv[2] == "1", sys.argv[3]
    mp.spawn(run, args=(port, flip, out), nprocs=2, join=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Both collective runs (clean, and rank 1's byte flipped in transit)
    of two gloo ranks, each in a subprocess; the ranks' saved results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    runs = {}
    for flip in (False, True):          # both pairs at once
        d = tmp_path_factory.mktemp(f"gloo{int(flip)}")
        script = d / "ranks.py"
        script.write_text(_RANK_SCRIPT)
        runs[flip] = (d, subprocess.Popen(
            [sys.executable, str(script), str(_free_port()),
             str(int(flip)), str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for flip, (d, proc) in runs.items():
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        out[flip] = [torch.load(d / f"rank{r}.pt") for r in (0, 1)]
    return out


@pytest.mark.parametrize("flip", [False, True])
def test_checked_psum_over_two_gloo_ranks(gloo_runs, flip):
    r0, r1 = gloo_runs[flip]
    for k in ("w", "b"):
        # every rank holds the same sum; it is the ranks' payload sum
        assert torch.equal(r0["summed"][k], r1["summed"][k])
        assert torch.equal(r0["summed"][k], r0["q"][k] + r1["q"][k])
        assert torch.equal(r0["scale"][k],
                           r0["scale_in"][k] + r1["scale_in"][k])
    # additivity: a transit flip on rank 1 moves the summed residue of
    # one leaf; both ranks see it after the reduction, and only the
    # corrupted rank's local verify attributes it
    assert r0["errs"] == r1["errs"] == (1 if flip else 0)
    assert (r0["local"], r1["local"]) == ((0, 1) if flip else (0, 0))
