"""ROADMAP §A7's families in the port against the JAX package, at their
reduced configs: the VLM llava-next-mistral-7b (the patch projector) and
the dense internlm2-20b here, with the configs, the data pipeline, the
CLI's ``--smoke`` and the refusals of all four (the hybrid hymba-1.5b's
models: ``tests/test_torch_mamba.py``; the encoder-decoder
whisper-large-v3's: ``tests/test_torch_whisper.py``).

Each model runs a prefill and 3 greedy decode steps through weights
carried by ``from_jax``, the JAX side op by op (ROADMAP §C5), in float32
under a bf16-cache and a ``kv_cache:on`` plan; its logits are held to
``tests/test_torch_lm.py``'s 2**-5 for float32 runs whose int8 codes may
split at a rounding (a share of the reference's largest magnitude) and
its FaultReport counters exactly.  The serving engines of both packages
serve the same burst (every arrival inside one step) to the same tokens,
steps and counters, in float32 (``torch_family_parity``).  The two
configs that do not fit one card at full depth, mistral-large-123b and
llama4-scout-17b-a16e, are served the same way at their reduced
configs.  What the port still refuses: the paged lanes for hymba, llava
and whisper (as JAX does).  The three train (``tests/test_torch_train_*.py`` hold them to
JAX): here the facade's loss on the port's own float weights.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.reduce import small_arch  # noqa: E402
from repro.data import pipeline as j_data  # noqa: E402
from repro.models import base as j_base  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.paging import PagingConfig as JPaging  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.registry import SHARDED_ONLY  # noqa: E402
from repro_torch.data import pipeline as t_data  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.paging import PagingConfig  # noqa: E402
from repro_torch.serving import ServingEngine, TenantSpec  # noqa: E402
from torch_family_parity import (KV_PLAN, PROMPT, TOL, cfgs,  # noqa: E402
                                 check_run, check_tree, ctxs,
                                 engine_matches_jax, metrics, run_both,
                                 same_metrics, scaled_err, weights)

FAMILIES = {"whisper-large-v3": "encdec", "hymba-1.5b": "hybrid",
            "llava-next-mistral-7b": "vlm", "internlm2-20b": "dense"}
#: the families this file runs (hymba: tests/test_torch_mamba.py; whisper:
#: tests/test_torch_whisper.py)
LMS = ("llava-next-mistral-7b", "internlm2-20b")


# ------------------------------ configs -------------------------------------

@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_configs_and_reduced_configs_are_the_jax_ones(arch):
    full, small = get_arch(arch), reduce_cfg(get_arch(arch))
    assert dataclasses.asdict(full) == dataclasses.asdict(j_arch(arch))
    assert dataclasses.asdict(small) == dataclasses.asdict(small_arch(arch))
    assert full.family == FAMILIES[arch]


def test_registry_still_refuses_the_sharded_ids(tmp_path, caplog):
    # the two ids that do not fit one card at full depth are registered
    # (their configs are JAX's field for field) and trained like any
    # other arch: the train CLI runs their reduced configs
    import logging
    caplog.set_level(logging.INFO)
    from repro_torch.launch import train
    assert sorted(SHARDED_ONLY) == ["llama4-scout-17b-a16e",
                                    "mistral-large-123b"]
    for arch in SHARDED_ONLY:
        assert dataclasses.asdict(get_arch(arch)) == \
            dataclasses.asdict(j_arch(arch))
        assert train.main(["--arch", arch, "--device", "cpu", "--smoke",
                           "--steps", "2", "--seq-len", "16", "--batch",
                           "2", "--ckpt-dir", str(tmp_path / arch)]) == 0
        assert "'faulty_steps': 0" in caplog.text


# ------------------------------ the prefix ----------------------------------

@pytest.mark.parametrize("arch", ["hymba-1.5b", "llava-next-mistral-7b"])
def test_prefix_embeds_match_jax(arch):
    j_cfg, cfg = cfgs(arch)
    w = weights(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, PROMPT, cfg.d_model)).astype(np.float32)
    patches = rng.standard_normal((1, cfg.n_patches or 1,
                                   cfg.patch_dim or 1)).astype(np.float32)
    jctx, tctx = ctxs("float32")
    jrep, trep = [], []
    with jax.disable_jit():
        want = j_lm._prefix_embeds(jax.tree.map(jnp.asarray, w),
                                   jnp.asarray(x), jctx, j_cfg,
                                   jnp.asarray(patches), jrep)
    got = t_lm._prefix_embeds(from_jax(w, "cpu"), torch.from_numpy(x), tctx,
                              cfg, torch.from_numpy(patches), trep)
    prefix = cfg.meta_tokens + cfg.n_patches
    assert prefix > 0
    assert tuple(got.shape) == want.shape == (1, prefix + PROMPT,
                                              cfg.d_model)
    assert scaled_err(got, want) <= TOL["float32"]
    assert len(trep) == len(jrep) == (2 if cfg.patch_dim else 0)
    for t, j in zip(trep, jrep):
        same_metrics(metrics(t), metrics(j))


# ------------------------------ the models ----------------------------------

#: K1 checks a step of each reduced model: (prefill, decode); 7 a layer
#: and the head, llava's projector (2) at the prefill
_K1 = {"llava-next-mistral-7b": (2 + 2 * 7 + 1, 2 * 7 + 1),
       "internlm2-20b": (2 * 7 + 1, 2 * 7 + 1)}


@pytest.mark.parametrize("arch", LMS)
@pytest.mark.parametrize("plan_text", ["*:policy=log", KV_PLAN])
def test_family_prefill_and_decode_match_jax(arch, plan_text):
    out, _ = run_both(arch, "float32", plan_text)
    check_run(out, "float32", _K1[arch],
              2 if plan_text == KV_PLAN else 0)


@pytest.mark.parametrize("arch", LMS)
def test_family_tree_and_victims_are_the_jax_ones(arch):
    j_cfg, cfg = cfgs(arch)
    check_tree(arch, t_base.build_model(cfg).init(0, quant=True,
                                                  device="cpu"),
               ("attn.wq", "mlp.down", "projector.fc1", "projector.fc2",
                "ssm.out_proj", "embed.table"))
    jc = j_base.Model(j_cfg).init_cache(3, 40)
    tc = t_base.Model(cfg).init_cache(3, 40, device="cpu")
    assert set(tc) == set(jc) == {"attn"}
    for k in ("k", "v"):
        assert tuple(tc["attn"][k].shape) == jc["attn"][k].value.shape


#: the two configs that do not fit one card at full depth, reduced: K1
#: checks a step (prefill, decode): Mistral-Large 7 a layer and the
#: head; Llama-4-Scout's MoE layers 4 attention projections and 3 x 4
#: experts, and the head
_K1_SHARDED = {"mistral-large-123b": (2 * 7 + 1, 2 * 7 + 1),
               "llama4-scout-17b-a16e": (2 * 16 + 1, 2 * 16 + 1)}


@pytest.mark.parametrize("arch", sorted(SHARDED_ONLY))
def test_sharded_config_prefill_and_decode_match_jax(arch):
    """Served by the port as by JAX, on JAX's numpy weights through the
    converter: each step's logits within the LM tolerance, the counters
    JAX's, no error (the engine test below runs a ``kv_cache:on``
    lane)."""
    out, _ = run_both(arch, "float32", "*:policy=log")
    check_run(out, "float32", _K1_SHARDED[arch], 0)


@pytest.mark.parametrize("arch", sorted(SHARDED_ONLY))
def test_sharded_config_engine_matches_jax(arch):
    engine_matches_jax(arch)


# ------------------------------ the engine ----------------------------------

@pytest.mark.parametrize("arch", LMS)
def test_engine_matches_jax_engine(arch):
    engine_matches_jax(arch)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_chat_batches_are_the_jax_engines(arch):
    """The request's rng draws its tokens, then llava's patches or
    whisper's frames, as the JAX engine's does."""
    from repro.serving import Request as JRequest
    from repro_torch.serving import Request
    j_eng = JEngine.__new__(JEngine)
    j_eng.cfg, j_eng.max_prompt = small_arch(arch), 16
    eng = ServingEngine.__new__(ServingEngine)
    eng.cfg, eng.max_prompt, eng.device = reduce_cfg(get_arch(arch)), 16, \
        torch.device("cpu")
    kw = dict(rid=0, tenant="a", arrival_s=0.0, prompt_len=16,
              max_new_tokens=2, seed=9)
    want = j_eng._chat_batch(JRequest(**kw))
    got = eng._chat_batch(Request(**kw))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == (torch.int32 if k == "tokens"
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------ data, CLI, refusals -------------------------

@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_pipeline_batches_and_specs_equal_jax(arch, kind):
    j = j_data.make_dataset(j_arch(arch), JShape("s", kind, 700, 2))
    t = t_data.make_dataset(get_arch(arch), TShape("s", kind, 700, 2))
    assert isinstance(t, t_data.SyntheticLMDataset)
    for step in (0, 3):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    js = j_base.Model(j_arch(arch)).input_specs(JShape("s", kind, 700, 2))
    ts = t_base.Model(get_arch(arch)).input_specs(TShape("s", kind, 700, 2))
    assert set(js) == set(ts)
    for k, spec in ts.items():
        assert tuple(spec.shape) == js[k].value.shape
        assert str(spec.dtype).removeprefix("torch.") == \
            js[k].value.dtype.name


#: K1 checks a step of each reduced model: (prefill, decode); the
#: reduced hymba has 2 layers here
_CLI_K1 = {"whisper-large-v3": (37, 17), "hymba-1.5b": (21, 21),
           "llava-next-mistral-7b": (17, 15), "internlm2-20b": (15, 15)}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_serve_cli_smoke_on_cpu(tmp_path, arch):
    out = tmp_path / "tel.json"
    assert serve.main(["--arch", arch, "--device", "cpu", "--smoke",
                       "--requests", "3", "--rate", "1e6", "--json",
                       str(out)]) == 0
    tel = json.loads(out.read_text())
    s = tel["summary"]
    assert s["per_tenant"]["default"]["completed"] == 3
    c = s["faults"]["counters"]
    pre, dec = _CLI_K1[arch]
    kinds = [st["kind"] for st in tel["steps"]]
    assert c["qgemm_checks"] == pre * kinds.count("prefill") + \
        dec * kinds.count("decode")
    assert c["embedding_bag_checks"] == len(kinds)
    assert not any(v for k, v in c.items() if not k.endswith("_checks"))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "hymba-1.5b",
                                  "llava-next-mistral-7b"])
def test_paged_lanes_refuse_as_jax_does(arch):
    with pytest.raises(ValueError) as want:
        JEngine(small_arch(arch), [JTenant("a")],
                paging=JPaging(page_size=8, n_pages=64))
    with pytest.raises(ValueError) as got:
        ServingEngine(reduce_cfg(get_arch(arch)), [TenantSpec("a")],
                      paging=PagingConfig(page_size=8, n_pages=64),
                      device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "hymba-1.5b",
                                  "llava-next-mistral-7b"])
def test_the_families_train(arch):
    """``Model.loss`` over the port's own float weights: a finite loss,
    logits over the meta-token and patch prefix and the text, and a
    finite gradient reaching every leaf."""
    from repro_torch.core.inject import leaf_paths
    from repro_torch.launch.steps import make_grad_fn
    from torch_family_parity import train_batch
    cfg = reduce_cfg(get_arch(arch))
    model = t_base.build_model(cfg, max_pos=64)
    params = model.init(0, device="cpu")
    batch = from_jax(train_batch(cfg, 0), "cpu")
    (loss, metrics), grads = make_grad_fn(model, TCtx(
        quant=False, compute_dtype=torch.float32))(params, batch)
    assert np.isfinite(float(loss)) and float(metrics["aux_loss"]) == 0.0
    for path, g in leaf_paths(grads):
        assert torch.isfinite(g).all(), path
        if not path.endswith("wk.b"):   # 0 in exact arithmetic
            assert g.abs().max() > 0, path
