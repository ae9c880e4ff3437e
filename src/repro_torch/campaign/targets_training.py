"""Training-step injectable targets: faults in the optimizer pipeline (the
JAX package's ``campaign/targets_training.py``).

A real optimizer step, ``model.loss`` -> gradient -> int8 error-feedback
compression -> :func:`~repro_torch.runtime.compression.checked_psum` ->
decompress -> clip -> AdamW, the primitives and order of
``launch.steps.make_train_step(compress=True)`` with injection seams
between the stages (as in JAX: a fixed ``TRAIN_LR`` instead of the
schedule, one microbatch, the single-device collective), run for
``plan.steps`` consecutive steps over the seeded data pipeline with a bit
flip at the cell's seam:

* ``train_grad_pre``  — the raw f32 gradient before compression: the
  payload checksum is taken after the corruption, so the check verifies
  a consistently wrong payload (bound 0); int8 quantization masks
  low-bit flips.
* ``train_grad_post`` — the mean gradient after the verified reduction:
  the post-verify window (bound 0).
* ``train_payload``   — dtype ``int8``: the compressed payload between
  the checksum encode and the reduction, which the mod-8191 additivity
  check covers (bound 1); dtype ``float32``: the error-feedback
  residual, local state outside the checksum (bound 0) whose corruption
  surfaces a step later.
* ``train_moments``   — the AdamW first moment: silent optimizer-state
  corruption (bound 0).
* ``train_payload_shard`` — one rank's int8 payload after the encode,
  before the all-reduce: corruption in transit on a real mesh.  The
  corrupted rank's contribution shifts the summed residue while the sum
  of the per-rank checksums (encoded before the flip) does not, so the
  flip is seen after the collective by the additivity check (bound 1:
  |Δ| = 2^k ≤ 128 < 8191), never before.  At ``data_shards=1`` it is
  ``train_payload``.
* ``train_reduced``   — the summed int32 payload after the verified
  collective, before decompression: the post-reduction window (bound 0).

Over a data mesh (``plan.data_shards`` > 1, a
:func:`repro_torch.sharding.make_data_mesh` the executor hands the
build) every rank takes its own slice of the seeded stream
(``steps × shards + 1`` batches: rank ``s`` takes batch ``t × shards +
s`` at step ``t``), keeps its own error-feedback residual, and the
payload goes through a real all-reduce with the mod-8191 check live at
every step;
:func:`~repro_torch.runtime.compression.checked_psum_attributed` also
gives each rank's own receive-side count, folded into the artifact's
``shard_detections``.  Shard-local seams (:data:`SHARD_LOCAL_POINTS`)
strike rank 0 only; the others strike every rank alike, so the
parameters stay replicated.

Ground truth is a clean twin: the same steps over the same batches with
no flip, run once per cell at build.  ``corrupted`` is an exact
final-parameter mismatch; ``divergence`` (relative L2 parameter drift)
and ``loss_divergence`` say how far the fault went.  Transient faults
strike at step 0, persistent ones (``plan.persistent``) the same element
and bit every step.

Each cell draws JAX's own stream (:mod:`repro_torch.campaign.prng`): the
trial keys are ``split(split(key(seed), 3)[1], samples)`` and each key's
victim element and bit are drawn as ``repro.core.inject`` draws them, so
a trial flips the element and bit the JAX cell's trial flips.  The
weights come from the port's own init, seeded from the cell's build key
(a test hands the JAX cell's weights in through ``params``).

On the card the steps run under ``torch.use_deterministic_algorithms``:
the clean twin is an exact comparison, and a nondeterministic embedding
backward or GEMM would count every trial as corrupted.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.campaign import prng
from repro_torch.campaign.spec import CellPlan
from repro_torch.campaign.targets import (Fault, InjectableTarget, Trial,
                                          inject_, register_target)
from repro_torch.core.inject import (bit_band, signed_view,
                                     victim_leaf_index, wrap_signed)
from repro_torch.core.tree import tree_leaves
from repro_torch.device import deterministic
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm)
from repro_torch.runtime.compression import (CompressionState,
                                             checked_psum,
                                             checked_psum_attributed,
                                             compress_grads,
                                             decompress_grads,
                                             init_compression, psum)

TRAIN_ARCH = "llama3.2-1b"
TRAIN_LR = 1e-3
MAX_GRAD_NORM = 1.0

#: default injection victim: an MLP projection, not the largest leaf (the
#: token table, whose gradient is mostly zeros: a flip there is crushed
#: by AdamW's eps, every trial masked)
TRAIN_DEFAULT_VICTIM = "mlp"

#: injection seams, in pipeline order
INJECT_POINTS = ("grad_pre", "payload", "payload_shard", "error_feedback",
                 "reduced", "grad_post", "moment")

#: seams that strike a rank's own state on a data mesh: rank 0 only;
#: every other seam strikes replicated values alike on every rank
SHARD_LOCAL_POINTS = ("grad_pre", "payload_shard", "error_feedback")


def _inject_point(plan: CellPlan) -> str:
    """The seam a cell injects at; ``train_payload`` picks the payload
    (int8) or the error-feedback residual (float32) by its dtype."""
    point = {"train_grad_pre": "grad_pre", "train_grad_post": "grad_post",
             "train_moments": "moment",
             "train_payload_shard": "payload_shard",
             "train_reduced": "reduced"}.get(plan.target)
    if point is not None:
        return point
    return "payload" if plan.dtype == "int8" else "error_feedback"


def _seam_dtype(plan: CellPlan) -> torch.dtype:
    """The dtype of the leaf the seam flips: the payload's int8, the
    summed payload's int32, every other seam's tree float32."""
    return {"payload": torch.int8, "payload_shard": torch.int8,
            "reduced": torch.int32}.get(_inject_point(plan), torch.float32)


def cell_keys(plan: CellPlan) -> np.ndarray:
    """The cell's build, trial and clean keys (JAX's executor split)."""
    return prng.split(prng.key(plan.seed), 3)


def _fault_at(key: np.ndarray, size: int, dtype: torch.dtype,
              plan: CellPlan) -> Tuple[Fault, ...]:
    """The faults JAX's ``apply_fault(key, leaf, plan)`` strikes on a leaf
    of ``size`` elements and ``dtype`` (not a packed weight, so the live
    region is the whole leaf)."""
    nbits = torch.empty((), dtype=dtype).element_size() * 8
    if plan.fault_model == "random_value":
        k1, k2 = prng.split(key)
        idx = int(prng.randint(k1, (), 0, size))
        rnd = int(prng.random_bits(k2, ())) & ((1 << min(nbits, 32)) - 1)
        return (Fault(idx, value=wrap_signed(rnd, nbits)),)
    if plan.fault_model != "bitflip":
        raise ValueError(f"unknown fault model {plan.fault_model!r}")
    lo, hi = bit_band(dtype, plan.bit_band)
    if plan.flips == 1:
        k1, k2 = prng.split(key)
        return (Fault(int(prng.randint(k1, (), 0, size)),
                      int(prng.randint(k2, (), lo, hi))),)
    # random_bitflips: distinct indices by Floyd's algorithm
    k_idx, k_bit = prng.split(key)
    sel: List[int] = []
    for t in range(plan.flips):
        i = size - plan.flips + t
        j = int(prng.randint(prng.fold_in(k_idx, t), (), 0, i + 1))
        sel.append(i if j in sel else j)
    bits = prng.randint(k_bit, (plan.flips,), lo, hi)
    return tuple(Fault(i, int(b)) for i, b in zip(sel, bits))


def _fwd_errors(metrics) -> torch.Tensor:
    """The forward's residual ABFT errors (keyed counters, no aliases)."""
    from repro_torch.core.policy import op_kinds
    return sum((metrics[f"abft/{op}_errors"] for op in op_kinds()), 0)


def _train_build(plan: CellPlan, gen: torch.Generator, *, device,
                 plain: bool = False, params=None, mesh=None):
    """The reduced Llama-3.2-1B, its optimizer and compression state, the
    cell's batches (this rank's, over ``mesh``) and the clean twin.  The
    path runs no kernel, so ``plain`` changes nothing."""
    del gen, plain
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device as tree_to
    from repro_torch.protect import default_plan

    dev = torch.device(device)
    shards = mesh.size if mesh is not None else 1
    batch, seq_len = plan.shape
    cfg = reduce_cfg(get_arch(TRAIN_ARCH))
    model = build_model(cfg)
    ctx = Ctx(plan=default_plan(), quant=False, compute_dtype=torch.float32)
    if params is None:
        seed = int(prng.random_bits(cell_keys(plan)[0], ())) & 0x7FFFFFFF
        params = model.init(seed, device="cpu")
    params = tree_to(params, dev)

    # the seeded pipeline's batches, one a step (a rank's own on a mesh:
    # every rank reduces a different payload), plus a held-out batch the
    # post-soak loss is taken on (a fault in the last update moves only
    # that loss)
    dataset = make_dataset(cfg, ShapeConfig("campaign", "train",
                                            seq_len, batch))
    me = mesh.rank if mesh is not None else 0
    per_step = [to_device(dataset.batch_at(t * shards + me), dev)
                for t in range(plan.steps)]
    per_step.append(to_device(dataset.batch_at(plan.steps * shards), dev))
    grad_fn = make_grad_fn(model, ctx)

    def loss_only(p, mb):
        with torch.no_grad():
            return model.loss(p, mb, ctx)[0]

    victim_idx, victim_path = victim_leaf_index(
        params, plan.victim or TRAIN_DEFAULT_VICTIM, prefer_int8=False)
    state = {"params": params, "opt": adamw_init(params),
             "comm": init_compression(params),
             "batches": per_step[:-1], "eval_batch": per_step[-1],
             "grad_fn": grad_fn, "loss_only": loss_only,
             "victim_idx": victim_idx, "victim_path": victim_path,
             "victim_numel": tree_leaves(params)[victim_idx].numel(),
             "device": dev, "mesh": mesh}
    clean_params, clean_errs, clean_losses, clean_final, _ = _run_soak(
        state, plan, (), [False] * plan.steps)
    state.update(clean_params=clean_params, clean_errs=clean_errs,
                 clean_losses=clean_losses, clean_final_loss=clean_final)
    return state


def _flip_(tree, vidx: int, faults) -> None:
    """Strike ``faults`` into leaf ``vidx`` of ``tree``, in place (every
    seam's tree is a new tensor tree of the step, or the state it
    hands to the next step)."""
    leaf = tree_leaves(tree)[vidx]
    inject_(signed_view(leaf), faults, leaf.element_size() * 8)


def _run_soak(state, plan: CellPlan, faults, mask) -> Tuple:
    """``plan.steps`` train steps with ``faults`` struck at the cell's
    seam on the steps where ``mask`` is True.  -> (final params, errors
    [steps], losses [steps], the held-out loss of the final params, this
    rank's receive-side counts [steps]).  On a mesh the errors and
    losses are the mesh's (summed, averaged) and a shard-local seam
    strikes rank 0 only."""
    point = _inject_point(plan)
    vidx = state["victim_idx"]
    mesh = state["mesh"]
    group = mesh.group if mesh is not None else None
    shards = mesh.size if mesh is not None else 1
    on_rank = mesh is None or point not in SHARD_LOCAL_POINTS \
        or mesh.rank == 0
    params, opt, error = state["params"], state["opt"], state["comm"].error
    errs, losses, local = [], [], []
    with deterministic():
        for step, strike in enumerate(mask):
            strike = strike and bool(faults)
            here = strike and on_rank
            (loss, metrics), grads = state["grad_fn"](
                params, state["batches"][step])
            if here and point == "grad_pre":
                _flip_(grads, vidx, faults)
            payload, comm = compress_grads(grads,
                                           CompressionState(error=error))
            if here and point in ("payload", "payload_shard"):
                # at data_shards=1 one shard's payload is the payload
                _flip_(payload["q"], vidx, faults)
            if here and point == "error_feedback":
                _flip_(comm.error, vidx, faults)
            if mesh is None:
                # the single-device check is the receive-side verify
                summed, scale_sum, comm_errs = checked_psum(payload, None)
                mine = comm_errs
            else:
                summed, scale_sum, comm_errs, mine = \
                    checked_psum_attributed(payload, group)
            if strike and point == "reduced":
                # after the verify: every rank's sum flipped alike
                _flip_(summed, vidx, faults)
            mean = decompress_grads(summed, scale_sum, shards)
            if strike and point == "grad_post":
                _flip_(mean, vidx, faults)
            clipped, _ = clip_by_global_norm(mean, MAX_GRAD_NORM)
            params, opt = adamw_update(clipped, opt, params, TRAIN_LR)
            if strike and point == "moment":
                _flip_(opt["m"], vidx, faults)
            error = comm.error
            fwd = _fwd_errors(metrics)
            if mesh is not None:
                fwd = psum(torch.as_tensor(fwd, dtype=torch.int32,
                                           device=loss.device), group)
                loss = psum(loss, group) / torch.tensor(
                    float(shards), device=loss.device)
            errs.append(fwd + comm_errs)
            losses.append(loss)
            local.append(mine)
        final_loss = state["loss_only"](params, state["eval_batch"])
    return (params, torch.stack(errs), torch.stack(losses), final_loss,
            torch.stack(local))


def divergence(params_f, params_c) -> Tuple[torch.Tensor, torch.Tensor]:
    """(relative L2 drift, exact-mismatch bool) against the clean twin."""
    lf, lc = tree_leaves(params_f), tree_leaves(params_c)
    num = sum(torch.sum(torch.square(a.to(torch.float32)
                                     - b.to(torch.float32)))
              for a, b in zip(lf, lc))
    den = sum(torch.sum(torch.square(b.to(torch.float32))) for b in lc)
    rel = torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-30)
    changed = torch.stack([torch.any(a != b) for a, b in zip(lf, lc)]).any()
    return rel, changed


def _train_draw(state, plan: CellPlan, gen, n: int, faulty: bool):
    """``n`` trials' faults from the cell's JAX key stream (the faulty
    trials' keys; clean trials strike nothing)."""
    del gen
    if not faulty:
        return [Trial()] * n
    keys = prng.split(cell_keys(plan)[1], n)
    return [Trial(_fault_at(k, state["victim_numel"], _seam_dtype(plan),
                            plan)) for k in keys]


def _train_soak(state, plan: CellPlan, t: Trial) -> dict:
    steps = plan.steps
    mask = [True] * steps if plan.persistent \
        else [s == 0 for s in range(steps)]
    params_f, errs, losses, final_loss, local = _run_soak(
        state, plan, t.faults, mask)
    div, changed = divergence(params_f, state["clean_params"])
    loss_div = torch.maximum(
        torch.max(torch.abs(losses - state["clean_losses"])),
        torch.abs(final_loss - state["clean_final_loss"]))
    out = {"detected_steps": errs > 0, "corrupted": changed,
           "divergence": div, "loss_divergence": loss_div}
    mesh = state["mesh"]
    if mesh is not None:
        # per-rank attribution: did rank s's receive-side verify fire
        import torch.distributed as dist
        mine = (local.sum() > 0).to(torch.int32).reshape(1)
        every = [torch.empty_like(mine) for _ in range(mesh.size)]
        dist.all_gather(every, mine, group=mesh.group)
        out["shard_detected"] = torch.cat(every) > 0
    return out


def _train_trial(state, plan: CellPlan, t: Trial):
    """A clean trial: the clean twin's flags, taken once at build (its
    trajectory is deterministic); any flag is a false positive."""
    assert not t.faults, "training targets run their faulty trials as soaks"
    return torch.any(state["clean_errs"] > 0), False


def _train_overhead(state, plan: CellPlan):
    """One protected (compress + checked reduction) against one plain
    train step, for the canonical cell only (the int8 payload seam at
    the significant band, one step), as in JAX: the thunks do not depend
    on the cell's seam, band or dtype."""
    if not (_inject_point(plan) == "payload"
            and plan.bit_band == "significant" and plan.steps == 1
            and plan.data_shards == 1):
        return None
    grad_fn = state["grad_fn"]
    params, opt, comm = state["params"], state["opt"], state["comm"]
    mb = state["batches"][0]

    def protected():
        _, grads = grad_fn(params, mb)
        payload, _ = compress_grads(grads, comm)
        summed, scale_sum, errs = checked_psum(payload, None)
        mean = decompress_grads(summed, scale_sum, 1)
        clipped, _ = clip_by_global_norm(mean, MAX_GRAD_NORM)
        return adamw_update(clipped, opt, params, TRAIN_LR)[0], errs

    def unprotected():
        _, grads = grad_fn(params, mb)
        clipped, _ = clip_by_global_norm(grads, MAX_GRAD_NORM)
        return adamw_update(clipped, opt, params, TRAIN_LR)[0]

    return protected, unprotected


def _train_bound(plan: CellPlan):
    if _inject_point(plan) in ("payload", "payload_shard"):
        # |Δ| = 2^k ≤ 128 < 8191: one int8 bit flip always moves the
        # payload's residue (one rank's moves the sum's; the same flip
        # on every rank may cancel mod 8191 and leave the sum clean:
        # masked, so the effective rate the bound speaks of is still 1)
        if plan.fault_model == "bitflip" and plan.flips == 1:
            return 1.0
        return None
    # every other seam lies outside the transport checksum by design
    return 0.0


_F32_BANDS = ("all", "low", "significant", "sign", "exponent", "mantissa",
              "high_mantissa")
_TRAIN_SHAPES = ((2, 16),)     # (batch, seq_len) of the reduced LM


def _register(name: str, dtypes: Tuple[str, ...],
              bands: Tuple[str, ...]) -> None:
    register_target(InjectableTarget(
        name=name, build=_train_build, draw=_train_draw,
        trial=_train_trial, soak=_train_soak,
        default_shapes=_TRAIN_SHAPES, shape_arity=2, dtypes=dtypes,
        bands=bands, analytic_bound=_train_bound,
        overhead=_train_overhead, multi_flip=True, victim_selectable=True,
        shardable=True))


_register("train_grad_pre", ("float32",), _F32_BANDS)
_register("train_grad_post", ("float32",), _F32_BANDS)
_register("train_payload", ("int8", "float32"), _F32_BANDS)
_register("train_moments", ("float32",), _F32_BANDS)
# the mesh seams: one rank's payload in transit (seen after the
# all-reduce by the additivity check) and the summed int32 payload after
# the verified collective (the post-reduction escape window)
_register("train_payload_shard", ("int8",),
          ("all", "low", "significant", "sign"))
_register("train_reduced", ("int32",),
          ("all", "low", "significant", "sign"))


__all__ = ["TRAIN_ARCH", "TRAIN_LR", "MAX_GRAD_NORM", "INJECT_POINTS",
           "SHARD_LOCAL_POINTS", "cell_keys", "divergence"]
