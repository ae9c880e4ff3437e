"""The train step, the fault-tolerant loop and the train CLI over every
family the port trains, on the CPU: the training state's shapes against
JAX's ``train_state_lp``, a few ``TrainLoop`` steps (2 accumulated
microbatches, the checked int8 compression, recompute) against the JAX
package's loop over its jitted step on the same initial state and
batches, and ``python -m repro_torch.launch.train --smoke`` for each
family.

The loop's first loss is held to 1e-4 of JAX's (its step is jitted:
XLA's fusions keep float32 intermediates around the bf16 attention that
an op-by-op run rounds, ROADMAP §C5), the later ones to 1e-3: after
AdamW steps whose first updates are ``lr · sign(g)``, which a near-zero
gradient's round-off can flip (``lr`` 1e-3 here).  The loop's stats and
the ``comm/errors`` of every step are equal (0).
"""
import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models import base as j_base  # noqa: E402
from repro.runtime import LoopConfig as JConfig  # noqa: E402
from repro.runtime import TrainLoop as JLoop  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.runtime import LoopConfig, TrainLoop  # noqa: E402

from torch_family_parity import train_cfgs  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "rwkv6-1.6b", "whisper-large-v3",
         "hymba-1.5b", "llava-next-mistral-7b"]


def _models(arch, accum=1):
    jc, tc = (dataclasses.replace(c, train_accum=accum)
              for c in train_cfgs(arch))
    seq = 16 + tc.meta_tokens + tc.n_patches
    max_pos = seq + tc.meta_tokens + 8          # the train CLI's
    return (j_base.Model(jc, max_pos=max_pos),
            t_base.Model(tc, max_pos=max_pos), seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shapes_match_jax(arch):
    jm, tm, _ = _models(arch)
    j_lp = jsteps.train_state_lp(jm, compress=True)
    want = [(v.value.shape, v.value.dtype.name) for v in jax.tree.leaves(
        j_lp, is_leaf=lambda x: hasattr(x, "axes"))]
    shapes = tsteps.train_state_shapes(tm, compress=True)
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree_leaves(shapes)]
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert tsteps.state_bytes(shapes) == sum(
        int(np.prod(s)) * 4 for s, _ in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_against_jax(arch, tmp_path):
    jm, tm, seq = _models(arch, accum=2)
    kw = dict(accum=2, peak_lr=1e-3, warmup=0, total_steps=10,
              compress=True)
    jdata = j_dataset(jm.cfg, JShape("t", "train", seq, 4))
    tdata = make_dataset(tm.cfg, ShapeConfig("t", "train", seq, 4))
    for step in range(3):
        for k, v in jdata.batch_at(step).items():
            assert np.array_equal(v, tdata.batch_at(step)[k]), k
    js = jsteps.init_train_state(jm, jax.random.key(0), compress=True)
    ts = from_jax(jax.tree.map(np.asarray, jax.device_get(js)), "cpu")
    jstep = jax.jit(jsteps.make_train_step(
        jm, JCtx(quant=False, compute_dtype=jnp.float32), **kw))
    tstep = tsteps.make_train_step(
        tm, Ctx(quant=False, compute_dtype=torch.float32), **kw)
    jmet, tmet = [], []
    jloop = JLoop(jstep, jdata, cfg=JConfig(ckpt_dir=str(tmp_path / "j"),
                                            log_every=1),
                  metrics_hook=lambda s, m: jmet.append(m))
    tloop = TrainLoop(tstep, tdata, cfg=LoopConfig(
        ckpt_dir=str(tmp_path / "t"), log_every=1),
        metrics_hook=lambda s, m: tmet.append(m))
    jloop.run(js, 3)
    tloop.run(ts, 3)
    assert tloop.stats == jloop.stats == {
        "recomputes": 0, "restores": 0, "faulty_steps": 0}
    assert len(jmet) == len(tmet) == 3
    for i, (a, b) in enumerate(zip(jmet, tmet)):
        want = float(a["loss_final"])
        assert np.isfinite(b["loss_final"])
        tol = 1e-4 if i == 0 else 1e-3
        assert abs(b["loss_final"] - want) <= tol * abs(want), i
        assert b["comm/errors"] == float(a["comm/errors"]) == 0
        assert abs(b["aux_loss"] - float(a["aux_loss"])) <= \
            tol * abs(float(a["aux_loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_family_on_the_cpu(arch, tmp_path, caplog):
    from repro_torch.launch import train
    caplog.set_level(logging.INFO, logger="repro_torch.train")
    assert train.main(["--arch", arch, "--device", "cpu", "--smoke",
                       "--steps", "2", "--compress", "--ckpt-dir",
                       str(tmp_path / "ck")]) == 0
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done:")]
    assert done and "'comm/errors': 0.0" in done[0]
    assert "'faulty_steps': 0" in done[0] and "'recomputes': 0" in done[0]
    assert (tmp_path / "ck" / "step_000000002" / "COMMIT").exists()
