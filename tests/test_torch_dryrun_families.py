"""The dry run's counts for every other architecture and the two configs
it registers (``tests/test_torch_dryrun_reduced.py`` runs one reduced
cell per family).

* ``params`` and MODEL_FLOPS of every arch but Llama-3.2-1B (held in
  ``tests/test_torch_dryrun*.py``) and the DLRM, exactly against the JAX
  package's ``count_params`` / ``model_flops`` over its
  ``jax.eval_shape`` tree: the float tree a train cell counts, the int8
  tree a serving cell counts;
* mistral-large-123b and llama4-scout-17b-a16e: JAX's configs field for
  field, run (reduced) by the serve CLI, the train CLI and the serving
  engine, which refused them before a model axis ran on real ranks
  (ROADMAP A8.4);
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as j_arch  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402
from repro.models.base import build_model as j_build  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import SHARDED_ONLY  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402

OTHERS = [a for a in dryrun.LM_ARCHS if a != "llama3.2-1b"]


def _max_pos(cfg, shape):
    return max(shape.seq_len, 4096) + cfg.meta_tokens + 1


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", OTHERS)
def test_params_and_model_flops_match_jax(arch, kind):
    shape = SHAPES["train_4k" if kind == "train" else "decode_32k"]
    cfg, jcfg = get_arch(arch), j_arch(arch)
    quant = kind == "serve"
    tree = build_model(cfg, _max_pos(cfg, shape)).init(
        0, quant=quant, device="meta")
    jm = j_build(jcfg, max_pos=_max_pos(jcfg, shape))
    jtree = jax.eval_shape(lambda: jm.init(jax.random.key(0), quant=quant))
    frac = (cfg.top_k / cfg.n_experts) if cfg.n_experts else None
    got = roofline.count_params(tree, active_moe=frac)
    want = j_roof.count_params(jtree, active_moe=frac)
    assert got == want
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    assert roofline.model_flops(shape.kind, got["active"], tokens=tokens) \
        == j_roof.model_flops(shape.kind, want["active"], tokens=tokens)


@pytest.mark.parametrize("arch", sorted(SHARDED_ONLY))
def test_sharded_configs_are_jax(arch):
    assert dataclasses.asdict(get_arch(arch)) == \
        dataclasses.asdict(j_arch(arch))
    assert arch in dryrun.LM_ARCHS


@pytest.mark.parametrize("entry", ["serve", "train", "engine"])
@pytest.mark.parametrize("arch", sorted(SHARDED_ONLY))
def test_entry_points_refuse_the_sharded_configs(arch, entry, caplog,
                                                 tmp_path):
    """No entry point refuses the two configs now: each runs their
    reduced configs on the CPU (serve: 2 requests; train: 2 steps; the
    engine: a burst of 2 chat requests), with no error."""
    if entry == "engine":
        from repro_torch.configs import reduce_cfg
        from repro_torch.protect import default_plan
        from repro_torch.serving import (ServingEngine, TenantSpec,
                                         chat_stream)
        eng = ServingEngine(reduce_cfg(get_arch(arch)), [TenantSpec(
            "default", default_plan(), 1.0)], n_slots=2, max_prompt=16,
            max_new_tokens=4, device="cpu")
        tel = eng.run(chat_stream(2, tenants={"default": 1.0},
                                  rate_rps=1e6, seed=0, mean_prompt=8,
                                  max_prompt=16, mean_output=2,
                                  max_output=4))
        assert tel.summary()["per_tenant"]["default"]["completed"] == 2
        return
    import logging
    caplog.set_level(logging.INFO)
    from repro_torch.launch import serve, train
    if entry == "serve":
        assert serve.main(["--arch", arch, "--device", "cpu", "--smoke",
                           "--requests", "2"]) == 0
    else:
        assert train.main(["--arch", arch, "--device", "cpu", "--smoke",
                           "--steps", "2", "--seq-len", "16", "--batch",
                           "2", "--ckpt-dir", str(tmp_path)]) == 0
        assert "'faulty_steps': 0" in caplog.text
