"""The JAX package's train CLI step on small host meshes, for the port's
tensor-parallel tests (``tests/test_torch_train_tp.py``).

The subprocess forces 4 host devices before JAX starts and runs the
unchanged JAX CLI's step: ``repro.launch.steps.make_train_step`` jitted
with ``in_shardings`` from ``train_state_lp`` and ``input_specs`` under
``train_rules`` on ``make_host_mesh(shape)`` (Auto axes), ``Ctx(rules=
train_rules())`` as the CLI passes.  The parameters are the port's (its
seeded init, handed over as numpy arrays in JAX's flatten order); 2
steps on the same global batches.  No JAX import here: nothing under
``src/repro`` is edited.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import reduce_cfg
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_arch
    from repro.launch import steps as js
    from repro.launch.mesh import make_host_mesh
    from repro.layers.common import Ctx
    from repro.models.base import build_model
    from repro.optim import adamw_init
    from repro.protect import default_plan
    from repro.sharding import shardings_of, values_of
    from repro.sharding.rules import train_rules

    d = sys.argv[1]
    cases = json.loads(sys.argv[2])
    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    for arch, shape in cases:
        tag = f"{arch}@{shape[0]}x{shape[1]}"
        model = build_model(reduce_cfg(get_arch(arch)), max_pos=64)
        like = values_of(jax.eval_shape(lambda: model.init(
            jax.random.key(0))))
        leaves, tdef = jax.tree.flatten(like)
        params = jax.tree.unflatten(tdef, [
            jnp.asarray(inp[f"{arch}/p{i}"]) for i in range(len(leaves))])
        rules = train_rules()
        ctx = Ctx(rules=rules, plan=default_plan(), quant=False,
                  compute_dtype=jnp.float32)
        mesh = make_host_mesh(tuple(shape))
        step = js.make_train_step(model, ctx, accum=1,
                                  peak_lr=float(inp["lr"]), warmup=0,
                                  total_steps=10)
        spec = ShapeConfig("tp", "train", int(inp["seq"]),
                           int(inp["batch"]))
        state_sh = shardings_of(js.train_state_lp(model), rules, mesh)
        batch_sh = shardings_of(model.input_specs(spec), rules, mesh)
        state = {"params": params, "opt": adamw_init(params),
                 "step": jnp.zeros((), jnp.int32)}
        with mesh:
            state = jax.device_put(state, state_sh)
            jitted = jax.jit(step, in_shardings=(state_sh, batch_sh),
                             out_shardings=(state_sh, None))
            for t in range(int(inp["steps"])):
                batch = {"tokens": jnp.asarray(inp[f"tokens{t}"]),
                         "labels": jnp.asarray(inp[f"labels{t}"])}
                state, met = jitted(state, batch)
                for k in ("loss_final", "grad_norm"):
                    out[f"{tag}/{k}{t}"] = np.asarray(met[k])
        for i, x in enumerate(jax.tree.leaves(state["params"])):
            out[f"{tag}/param{i}"] = np.asarray(x)
    np.savez(os.path.join(d, "jax.npz"), **out)
""")


def start(d: str, cases) -> subprocess.Popen:
    """Start the JAX steps of ``cases`` (``[arch, [data, model]]``) on the
    inputs in ``d/inputs.npz``; the results land in ``d/jax.npz``."""
    import json
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(
        [sys.executable, "-c", _CODE, d, json.dumps(cases)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float = 600) -> None:
    _, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"the JAX steps failed: {err[-3000:]}")
