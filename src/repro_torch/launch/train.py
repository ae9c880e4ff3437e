"""Training entry point: ``python -m repro_torch.launch.train``
(the JAX package's ``launch/train.py``).

Composes the stack: config -> float model -> train step (grad
accumulation, optional int8 error-feedback compression checked mod 8191,
clipping, warmup-cosine AdamW) -> seeded data pipeline -> fault-tolerant
loop (ABFT and ``comm/errors`` counters, detect -> recompute / restore,
checksummed async checkpoints, straggler telemetry).  Training runs
under ``torch.use_deterministic_algorithms`` (a recompute or a restart
reproduces the step bit for bit).

Trains every family the port serves (``--arch``: the dense LMs,
granite-moe with its load-balance loss, the float RWKV6, whisper, hymba
and llava).  Runs on the card unless ``--device cpu`` asks for the CPU
(without a card it raises).  ``--smoke`` reduces the arch to smoke
size.

``--mesh host --mesh-shape d,m`` trains over ``d·m`` ranks that
``--device-count`` launches (``d·m`` when it is absent): ``gloo`` ranks
on the CPU, one rank a device on the card.  With ``m`` = 1 the mesh is a
data mesh: each rank takes its rows of every microbatch, the float
gradients are mean-all-reduced over the data group and then every rank
takes the one-device step (``--compress``: the checked reduction with
``group=None``), JAX's jitted step on the global batch (a MoE's
load-balance statistics are all-reduced over the group first, ROADMAP
§C17).  With ``m`` > 1 the state and each microbatch are ``DTensor`` s
placed by ``train_rules`` (FSDP over ``data``, tensor parallelism over
``model``) and the step runs on them (:func:`repro_torch.launch.steps.
make_train_step` on a model mesh).  ``--mesh single|multi`` is the
production mesh, (16, 16) or (2, 16, 16): on a world smaller than 256
(512) ranks it exits with JAX's error on a host.  Rank 0 logs and writes
the checkpoints (a sharded state gathered to it leaf by leaf).

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu \\
        --smoke --steps 20 --compress
    python -m repro_torch.launch.train --device cpu --smoke \\
        --mesh-shape 2,1 --device-count 2 --compress
    python -m repro_torch.launch.train --device cpu --smoke \\
        --mesh-shape 2,2 --device-count 4 --steps 2
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import sys
import tempfile

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduce the arch to smoke size")
    ap.add_argument("--float-abft", action="store_true",
                    help="float ABFT checks on the training GEMMs")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression with "
                         "mod-8191 checksum verification (comm/errors "
                         "feeds the loop's fault policy)")
    ap.add_argument("--fault-policy", default="recompute",
                    choices=["log", "recompute", "restore"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default: the card; no fallback)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="host: a (data, model) mesh of --mesh-shape; "
                         "single / multi: the 256 / 512-rank production "
                         "mesh")
    ap.add_argument("--mesh-shape", default=None,
                    help="host mesh (data,model), e.g. 2,1 (default: "
                         "--device-count,1)")
    ap.add_argument("--device-count", type=int, default=0,
                    help="ranks to launch (default: the mesh's data axis)")
    return ap


def _mesh_ranks(ap, args) -> tuple:
    """The mesh the flags ask for, ``(data, model)`` or the production
    mesh's shape; a request the port cannot run exits with 2 naming its
    ROADMAP item (JAX's error where JAX's CLI fails alike)."""
    from repro_torch.launch.mesh import check_host_world, production_grid
    world = args.device_count
    if world < 0:
        ap.error(f"--device-count {world}: at least 1 rank")
    if args.mesh != "host":
        try:
            grid = production_grid(args.mesh == "multi", world or 1)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e} (the production mesh needs "
                     f"{256 if args.mesh == 'single' else 512} ranks: "
                     f"--device-count, ROADMAP A8.4)")
        shape = tuple(grid.shape)
    else:
        try:
            shape = tuple(int(x) for x in (args.mesh_shape or
                                           f"{world or 1},1").split(","))
        except ValueError:
            shape = ()
        if len(shape) != 2 or min(shape) < 1:
            ap.error(f"--mesh-shape {args.mesh_shape}: expected data,model")
    have = world or math.prod(shape)
    if args.device != "cpu":
        import torch
        have = min(have, torch.cuda.device_count())
    try:
        check_host_world(shape, have)
    except ValueError as e:
        ap.error(f"{e} (ROADMAP A8.1"
                 + (": one rank a device on the card)"
                    if args.device != "cpu" else ")"))
    return shape


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_arch
    try:
        get_arch(args.arch)
    except KeyError as e:
        ap.error(str(e))
    # cuBLAS reads it when CUDA initialises (deterministic GEMMs)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    shape = _mesh_ranks(ap, args)
    n = math.prod(shape)
    if n == 1:
        return train(args)
    from repro_torch.sharding import launch
    return launch(_train_rank, n, args=(args, shape), device=dev)


def _train_rank(world, args, shape) -> int:
    return train(args, world, shape)


def train(args, world=None, shape=(1, 1)) -> int:
    """Train as the flags say, on one device or as one rank of ``world``
    on the mesh of ``shape`` (a data mesh when its model axis is 1, the
    whole world either way)."""
    import torch

    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import BatchShard, make_dataset
    from repro_torch.device import deterministic, resolve_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.runtime import LoopConfig, TrainLoop
    from repro_torch.sharding.rules import train_rules

    lead = world is None or world.rank == 0
    logging.basicConfig(level=logging.INFO if lead else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.train")
    dev = world.device if world is not None else resolve_device(args.device)
    mesh = shardings = group = None
    n_batch, batch_rank = 1, 0
    if world is not None and shape[-1] == 1:
        from repro_torch.sharding import make_data_mesh
        mesh = make_data_mesh(world.size)
        n_batch, batch_rank, group = mesh.size, mesh.rank, mesh.group
    elif world is not None:
        import torch.distributed as dist

        from repro_torch.sharding import make_model_mesh
        mesh = make_model_mesh(shape)
        n_batch, batch_rank = mesh.n_batch, mesh.batch_rank
        group = dist.group.WORLD

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_cfg(cfg)
    if args.accum > 1:
        cfg = dataclasses.replace(cfg, train_accum=args.accum)
    parts = cfg.train_accum * n_batch
    if args.batch % parts:
        raise SystemExit(f"--batch {args.batch} is not a multiple of the "
                         f"{cfg.train_accum} accumulation microbatches"
                         + (f" x {n_batch} data ranks" if mesh else ""))
    if mesh is not None:
        shardings = BatchShard(batch_rank, n_batch, cfg.train_accum)

    data_shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    # whisper's learned decoder positions: the text, the meta tokens, 8
    model = build_model(cfg, max_pos=args.seq_len + cfg.meta_tokens + 8)
    tp = mesh if shape[-1] > 1 else None
    # JAX's CLI passes the train rules; they move nothing but on a model
    # mesh's DTensors
    ctx = Ctx(rules=train_rules(len(shape) == 3), quant=False,
              float_abft=args.float_abft, compute_dtype=torch.bfloat16)
    step_fn = make_train_step(model, ctx, accum=cfg.train_accum,
                              peak_lr=args.lr, total_steps=args.steps,
                              compress=args.compress, mesh=mesh)
    state = init_train_state(model, 0, compress=args.compress, device=dev,
                             mesh=tp)
    dataset = make_dataset(cfg, data_shape)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    log.info("arch=%s params=%.1fM device=%s accum=%d mesh=%s", cfg.name,
             n_params / 1e6, dev, cfg.train_accum, tuple(shape))

    def hook(step, metrics):
        log.info("step %d loss=%.4f gnorm=%.3f gemm_err=%d eb_err=%d"
                 " comm_err=%d",
                 step, float(metrics.get("loss_final", float("nan"))),
                 float(metrics.get("grad_norm", float("nan"))),
                 int(metrics.get("abft/gemm_errors", 0)),
                 int(metrics.get("abft/eb_errors", 0)),
                 int(metrics.get("comm/errors", 0)))

    loop = TrainLoop(
        step_fn, dataset,
        cfg=LoopConfig(ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                       fault_policy=args.fault_policy),
        shardings=shardings, group=group,
        metrics_hook=hook if lead else None)
    with deterministic():
        state, metrics = loop.run(state, args.steps)
    log.info("done: %s | loop stats %s",
             {k: float(v) for k, v in metrics.items()
              if k in ("loss_final", "grad_norm", "comm/errors")},
             loop.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
