"""Training entry point: ``python -m repro_torch.launch.train``
(the JAX package's ``launch/train.py``, one device).

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
size.  The JAX CLI's mesh flags (``--mesh``, ``--mesh-shape``,
``--device-count``) exit with 2, naming ROADMAP A8.

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu \\
        --smoke --steps 20 --compress
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import tempfile

#: flags of the JAX training CLI whose subsystems wait for later slices
_NOT_PORTED = {
    "--mesh": "A8 (sharding and launch: the device mesh)",
    "--mesh-shape": "A8 (sharding and launch: the device mesh)",
    "--device-count": "A8 (sharding and launch: the device mesh)",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP "
                     f"{_NOT_PORTED[option_string]})")


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
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="*", action=_NotPorted,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # cuBLAS reads it when CUDA initialises (deterministic GEMMs)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import make_dataset
    from repro_torch.device import deterministic, resolve_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.runtime import LoopConfig, TrainLoop

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.train")
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_cfg(cfg)
    if args.accum > 1:
        cfg = dataclasses.replace(cfg, train_accum=args.accum)
    if args.batch % cfg.train_accum:
        raise SystemExit(f"--batch {args.batch} is not a multiple of the "
                         f"{cfg.train_accum} accumulation microbatches")

    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    # whisper's learned decoder positions: the text, the meta tokens, 8
    model = build_model(cfg, max_pos=args.seq_len + cfg.meta_tokens + 8)
    ctx = Ctx(quant=False, float_abft=args.float_abft,
              compute_dtype=torch.bfloat16)
    step_fn = make_train_step(model, ctx, accum=cfg.train_accum,
                              peak_lr=args.lr, total_steps=args.steps,
                              compress=args.compress)
    state = init_train_state(model, 0, compress=args.compress, device=dev)
    dataset = make_dataset(cfg, shape)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    log.info("arch=%s params=%.1fM device=%s accum=%d", cfg.name,
             n_params / 1e6, dev, cfg.train_accum)

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
        metrics_hook=hook)
    with deterministic():
        state, metrics = loop.run(state, args.steps)
    log.info("done: %s | loop stats %s",
             {k: float(v) for k, v in metrics.items()
              if k in ("loss_final", "grad_norm", "comm/errors")},
             loop.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
