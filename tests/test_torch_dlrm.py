"""The port's DLRM forward against the JAX model on the same weights.

JAX ``init_dlrm`` -> ``values_of`` -> numpy -> ``from_jax`` -> both
``dlrm_forward`` s under the default plan, at the ``serve --smoke`` size.
The FaultReport metrics must be identical, clean and with injected flips;
the logits agree within a tolerance (see ``_LOGIT_TOL``).
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
from repro.models.dlrm import dlrm_forward as j_forward  # noqa: E402
from repro.models.dlrm import init_dlrm as j_init  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.protect import protect as j_protect  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS as T_EXTRAS  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.models.dlrm import dlrm_forward as t_forward  # noqa: E402
from repro_torch.models.dlrm import init_dlrm as t_init  # noqa: E402
from repro_torch.protect import default_plan as t_default_plan  # noqa: E402
from repro_torch.protect import protect as t_protect  # noqa: E402

_SMOKE = dict(table_rows=512, n_tables=4, emb_dim=32, bottom_mlp=(64, 32),
              top_mlp=(64, 32, 1))
J_EX = dataclasses.replace(J_EXTRAS, **_SMOKE)
T_EX = dataclasses.replace(T_EXTRAS, **_SMOKE)

# The two forwards share every integer: the same quantized activations
# feed the same int8 GEMMs, so C and all checks are equal.  Float work
# differs in order only — the f32 Gram sum and the dequant expressions are
# associated differently by XLA (measured: 2e-7 of the logit scale in f32,
# bit-equal in bf16, on these inputs).  The bounds leave room for one bf16
# rounding step (2**-7 relative) of the output in bf16 and for 1e-5 of the
# scale in f32; a lost or doubled term would move the logits by far more.
_LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


@pytest.fixture(scope="module")
def weights():
    p = values_of(jax.jit(functools.partial(j_init, ex=J_EX, quant=True))(
        jax.random.key(0)))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((10, J_EX.n_dense)).astype(np.float32)
    pools = rng.integers(1, 17, (J_EX.n_tables, 10))
    idx = rng.integers(0, J_EX.table_rows, (J_EX.n_tables, 10, 16))
    bags = np.where(np.arange(16)[None, None] < pools[..., None], idx,
                    -1).astype(np.int32)
    return dense, bags


def _run_both(np_params, dense, bags, dtype):
    jfwd = j_protect(functools.partial(j_forward, ex=J_EX),
                     j_default_plan(), compute_dtype=getattr(jnp, dtype))
    tfwd = t_protect(functools.partial(t_forward, ex=T_EX),
                     t_default_plan(), compute_dtype=getattr(torch, dtype))
    jl, jr = jfwd(jax.tree.map(jnp.asarray, np_params), jnp.asarray(dense),
                  jnp.asarray(bags))
    tl, tr = tfwd(from_jax(np_params, device="cpu"), torch.from_numpy(dense),
                  torch.from_numpy(bags))
    jm = {k: int(v) for k, v in jr.as_metrics().items()}
    tm = {k: int(v) for k, v in tr.as_metrics().items()}
    return np.asarray(jl, np.float32), tl.to(torch.float32).numpy(), jm, tm


def _assert_same_metrics(tm, jm):
    # other test modules may register extra JAX op kinds in this process;
    # those keys stay zero
    assert set(tm) <= set(jm)
    assert all(jm[k] == 0 for k in set(jm) - set(tm))
    assert tm == {k: jm[k] for k in tm}


def test_from_jax_keeps_layout(weights):
    p = from_jax(weights, device="cpu")
    assert len(p["bottom"]) == 2 and len(p["top"]) == 3
    assert p["bottom"][0]["w_packed"].shape == (13, 64 + 128)
    assert p["bottom"][0]["w_packed"].dtype == torch.int8
    assert p["tables"]["table"].shape == (4, 512, 32)
    assert p["tables"]["rowsums"].dtype == torch.int32
    np.testing.assert_array_equal(p["tables"]["alphas"].numpy(),
                                  weights["tables"]["alphas"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_forward_matches_jax(weights, batch, dtype):
    dense, bags = batch
    jl, tl, jm, tm = _run_both(weights, dense, bags, dtype)
    assert tl.shape == jl.shape == (10,)
    assert np.all(np.isfinite(tl))
    scale = np.max(np.abs(jl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=_LOGIT_TOL[dtype] * scale)
    _assert_same_metrics(tm, jm)
    assert tm["abft/qgemm_checks"] == 5
    assert tm["abft/embedding_bag_checks"] == 4
    assert tm["abft/qgemm_errors"] == tm["abft/embedding_bag_errors"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_fault_counters_match_jax_under_flips(weights, batch, dtype):
    dense, bags = batch
    bad = jax.tree.map(np.copy, weights)
    # one bit of bottom.0's weight payload (its checksum lane left stale)
    bad["bottom"][0]["w_packed"][3, 17] ^= np.int8(0x08)
    # one high bit of a row that bag 2 of table 0 reads (row sums stale)
    row = int(bags[0, 2, 0])
    bad["tables"]["table"][0, row, 5] ^= np.int8(-128)
    jl, tl, jm, tm = _run_both(bad, dense, bags, dtype)
    _assert_same_metrics(tm, jm)
    assert tm["abft/qgemm_errors"] > 0
    assert tm["abft/embedding_bag_errors"] >= 1


def test_init_dlrm_distributions():
    p = t_init(3, T_EX, device="cpu")
    w = p["bottom"][0]["w_packed"][:, :64]
    assert w.dtype == torch.int8 and int(w.min()) >= -127
    a = p["top"][1]["alpha"]
    assert float(a.min()) >= 1e-3 and float(a.max()) <= 2e-3
    t = p["tables"]
    assert t["table"].shape == (4, 512, 32) and int(t["table"].min()) >= -127
    assert float(t["alphas"].min()) >= 5e-3
    assert float(t["alphas"].max()) <= 2e-2
    assert float(t["betas"].abs().max()) <= 0.1
    # the stored encodings are consistent: no check fires on clean weights
    from repro_torch.protect import encode_tree
    enc = encode_tree(p)
    for layer, fresh in zip(p["bottom"] + p["top"],
                            enc["bottom"] + enc["top"]):
        assert torch.equal(layer["w_packed"], fresh["w_packed"])
        assert torch.equal(layer["colsum"], fresh["colsum"])
    assert torch.equal(t["rowsums"], enc["tables"]["rowsums"])
    # same seed, same weights
    q = t_init(3, T_EX, device="cpu")
    assert torch.equal(q["tables"]["table"], t["table"])


def test_dlrm_rejects_missing_card_without_cpu_opt_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init(0, T_EX)
