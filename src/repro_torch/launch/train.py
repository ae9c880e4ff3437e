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

``--mesh host --mesh-shape d,1`` trains data-parallel over ``d`` ranks
that ``--device-count d`` launches (``d`` when it is absent): ``gloo``
ranks on the CPU, one rank a device on the card.  Each rank takes its
rows of every microbatch; the float gradients are mean-all-reduced over
the data group and then every rank takes the one-device step
(``--compress``: the checked reduction with ``group=None``), JAX's
jitted step on the global batch.  Rank 0 logs and writes the
checkpoints.  A model axis (``--mesh-shape d,m``, m > 1) exits with 2
naming ROADMAP A8.4, and so does a MoE arch on a data mesh (its
load-balance loss is not a mean over the batch's rows, §C17);
``--mesh single|multi`` exits with the production mesh's error on a
world smaller than 256 (512) ranks, as JAX does on a host, and
otherwise with A8.4 (its model axis of 16).

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu \\
        --smoke --steps 20 --compress
    python -m repro_torch.launch.train --device cpu --smoke \\
        --mesh-shape 2,1 --device-count 2 --compress
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
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


def _mesh_ranks(ap, args) -> int:
    """The data axis the flags ask for; a request the port cannot run
    exits with 2 naming its ROADMAP item."""
    from repro_torch.launch.mesh import check_host_world, production_grid
    world = args.device_count
    if world < 0:
        ap.error(f"--device-count {world}: at least 1 rank")
    if args.mesh != "host":
        try:
            grid = production_grid(args.mesh == "multi", world or 1)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e} (the production mesh needs "
                     f"{256 if args.mesh == 'single' else 512} ranks; its "
                     f"model axis of 16 waits for ROADMAP A8.4)")
        ap.error(f"--mesh {args.mesh}: a {grid.shape} mesh has a model axis "
                 f"of 16: tensor parallelism is not ported yet (ROADMAP "
                 f"A8.4)")
    try:
        shape = tuple(int(x) for x in (args.mesh_shape or
                                       f"{world or 1},1").split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh-shape {args.mesh_shape}: expected data,model")
    d, m = shape
    if m > 1:
        ap.error(f"--mesh-shape {d},{m}: a model axis of {m} is tensor "
                 f"parallelism, not ported yet (ROADMAP A8.4)")
    if d > 1:
        from repro_torch.configs import get_arch
        if get_arch(args.arch).family == "moe":
            ap.error(f"--arch {args.arch} on a data mesh of {d}: the MoE's "
                     f"load-balance loss is taken over the whole batch, "
                     f"so the mean of the ranks' losses is not JAX's step "
                     f"on the global batch (ROADMAP A8.4, §C17)")
    have = world or d
    if args.device != "cpu":
        import torch
        have = min(have, torch.cuda.device_count())
    try:
        check_host_world(shape, have)
    except ValueError as e:
        ap.error(f"{e} (ROADMAP A8.1"
                 + (": one rank a device on the card)"
                    if args.device != "cpu" else ")"))
    return d


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_arch, refuse_unsharded
    try:
        get_arch(args.arch)
        refuse_unsharded(args.arch)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e))
    # cuBLAS reads it when CUDA initialises (deterministic GEMMs)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    d = _mesh_ranks(ap, args)
    if d == 1:
        return train(args)
    from repro_torch.sharding import launch
    return launch(_train_rank, d, args=(args,), device=dev)


def _train_rank(world, args) -> int:
    return train(args, world)


def train(args, world=None) -> int:
    """Train as the flags say, on one device or as one rank of ``world``
    (the data mesh is the whole world)."""
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

    lead = world is None or world.rank == 0
    logging.basicConfig(level=logging.INFO if lead else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.train")
    dev = world.device if world is not None else resolve_device(args.device)
    mesh = shardings = None
    if world is not None:
        from repro_torch.sharding import make_data_mesh
        mesh = make_data_mesh(world.size)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_cfg(cfg)
    if args.accum > 1:
        cfg = dataclasses.replace(cfg, train_accum=args.accum)
    parts = cfg.train_accum * (mesh.size if mesh is not None else 1)
    if args.batch % parts:
        raise SystemExit(f"--batch {args.batch} is not a multiple of the "
                         f"{cfg.train_accum} accumulation microbatches"
                         + (f" x {mesh.size} data ranks" if mesh else ""))
    if mesh is not None:
        shardings = BatchShard(mesh.rank, mesh.size, cfg.train_accum)

    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    # whisper's learned decoder positions: the text, the meta tokens, 8
    model = build_model(cfg, max_pos=args.seq_len + cfg.meta_tokens + 8)
    ctx = Ctx(quant=False, float_abft=args.float_abft,
              compute_dtype=torch.bfloat16)
    step_fn = make_train_step(model, ctx, accum=cfg.train_accum,
                              peak_lr=args.lr, total_steps=args.steps,
                              compress=args.compress, mesh=mesh)
    state = init_train_state(model, 0, compress=args.compress, device=dev)
    dataset = make_dataset(cfg, shape)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    log.info("arch=%s params=%.1fM device=%s accum=%d mesh=%s", cfg.name,
             n_params / 1e6, dev, cfg.train_accum,
             (mesh.size, 1) if mesh is not None else (1, 1))

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
        shardings=shardings, group=mesh.group if mesh is not None else None,
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
