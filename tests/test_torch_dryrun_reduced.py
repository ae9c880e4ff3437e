"""One reduced dry-run cell per family on a (2, 2) mesh of 4 fake ranks,
whose model axis divides the reduced heads (``DTensor`` does not split 4
heads over 16, where GSPMD tiles them): status ok, the arguments a
device holds equal to the local shards of the rules' placements (less
the inputs the step never reads, which JAX's records leave out too), the
layers' constraints issued as collectives, and the train cells of the
families without layer remat flagged.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402


def _max_pos(cfg, shape):
    return max(shape.seq_len, 4096) + cfg.meta_tokens + 1


#: one reduced cell a family, at a small shape (the reduced attention
#: chunk of 8 at the suite's 4k-32k tokens would run thousands of chunks)
REDUCED = [
    ("llama3.2-1b", ShapeConfig("tiny_train", "train", 32, 8)),
    ("granite-moe-3b-a800m", ShapeConfig("tiny_prefill", "prefill", 32, 4)),
    ("rwkv6-1.6b", ShapeConfig("tiny_decode", "decode", 64, 4)),
    ("hymba-1.5b", ShapeConfig("tiny_decode", "decode", 32, 4)),
    ("llava-next-mistral-7b", ShapeConfig("tiny_prefill", "prefill", 32, 4)),
    ("whisper-large-v3", ShapeConfig("tiny_train", "train", 16, 4)),
]


@pytest.mark.parametrize("arch,shape", REDUCED, ids=[a for a, _ in REDUCED])
def test_reduced_cell_per_family(arch, shape, tmp_path):
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.steps import train_state_shapes
    from repro_torch.sharding.logical import (cache_axes, input_axes,
                                              param_axes, specs_of,
                                              train_state_axes)
    cfg = reduce_cfg(get_arch(arch))
    mesh = ((2, 2), ("data", "model"))
    rec = dryrun.run_cell(arch, shape.name, False, str(tmp_path), cfg=cfg,
                          shape=shape, mesh_shape=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "pod2x2" and rec["n_devices"] == 4
    assert not torch.distributed.is_initialized()

    # the arguments a device holds: each leaf's global bytes over the
    # mesh axes its spec splits it by
    model = build_model(cfg, _max_pos(cfg, shape))
    rules = dryrun.rules_for(cfg, shape, False)
    sizes = dict(zip(*reversed(mesh)))

    def local_bytes(tree, axes):
        specs = specs_of(axes, tree, rules, sizes)
        total = 0
        for t, spec in zip(tree_leaves(tree), _spec_leaves(specs)):
            n = t.numel() * t.element_size()
            for part in spec:
                for a in (() if part is None else (part,)
                          if isinstance(part, str) else part):
                    n //= sizes[a]
            total += n
        return total

    specs = model.input_specs(shape)
    batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for k, s in specs.items()}
    want = local_bytes(batch, input_axes(specs))
    # an input the step never reads is no argument (XLA drops it from
    # the module, so JAX's records do): RWKV's decode position
    if cfg.family == "ssm" and shape.kind == "decode":
        want -= local_bytes({"pos": batch["pos"]},
                            input_axes({"pos": specs["pos"]}))
    if shape.kind == "train":
        state = train_state_shapes(model)
        want += local_bytes(state, train_state_axes(state["params"]))
    else:
        params = model.init(0, quant=True, device="meta")
        if shape.kind == "decode" and "meta" in params:
            # a decode step does not embed hymba's meta tokens again
            params = {k: v for k, v in params.items() if k != "meta"}
        want += local_bytes(params, param_axes(params))
        if shape.kind == "decode":
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")
            want += local_bytes(cache, cache_axes(cache))
    assert rec["memory_per_device"]["argument_bytes"] == want
    cost = rec["cost_per_device"]
    assert cost["flops"] > 0 and cost["collectives"]
    flagged = "no layer remat (ROADMAP A8.4)" in cost["flags"]
    assert flagged == (shape.kind == "train"
                       and cfg.family in dryrun.NO_LAYER_REMAT)


def _spec_leaves(specs):
    from repro_torch.sharding.logical import tree_of_specs_leaves
    return tree_of_specs_leaves(specs)
