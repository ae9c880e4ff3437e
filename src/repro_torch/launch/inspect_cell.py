"""Perf-loop profiler: per-op byte and flop attribution of one dry-run
cell (the JAX package's ``launch/inspect_cell.py``).

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell \\
        --arch rwkv6-1.6b --shape decode_32k --top 25

Runs the cell like :mod:`repro_torch.launch.dryrun` (meta tensors on a
fake world, no card) with the counter's attribution on, and prints the
top HBM-byte contributors (a collective's link bytes included) with
their share of the flops.  JAX groups by its ``op_name`` metadata; the
port's layers are functions, not ``nn.Module`` s, so an op's tag is its
call path (the ``repro_torch`` functions on the stack) and its aten op,
which map each hot spot back to a source line.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import production_shape
from repro_torch.models.base import build_model


def _short(tag: str, width: int = 105) -> str:
    """The tag's innermost frames: what fits in ``width``."""
    parts = tag.split("/")
    out = parts[-1]
    for p in reversed(parts[:-1]):
        p = p.rsplit(".", 1)[-1]
        if len(out) + len(p) + 1 > width:
            break
        out = f"{p}/{out}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.inspect_cell",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    args = ap.parse_args(argv)
    dr.parse_set(args.set)

    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    rules = dr.rules_for(cfg, shape, args.multi_pod)
    model = build_model(cfg, max_pos=max(shape.seq_len, 4096)
                        + cfg.meta_tokens + 1)
    mesh_shape, axes = production_shape(args.multi_pod)
    n = 1
    for s in mesh_shape:
        n *= s
    with dr.fake_world(n):
        mesh = dr.make_mesh(mesh_shape, axes)
        counter, _ = dr.run_step(model, shape, rules, mesh, attribute=True)

    by_bytes, by_flops = counter.by_path_bytes, counter.by_path_flops
    total_b = sum(by_bytes.values())
    total_f = sum(by_flops.values())
    print(f"\n== {args.arch} × {args.shape} — per-device totals: "
          f"{total_b / 1e9:.1f} GB, {total_f / 1e12:.2f} TFLOP ==")
    print(f"{'bytes':>10s} {'%':>5s} {'flops%':>6s}  call path / op")
    for tag, b in by_bytes.most_common(args.top):
        print(f"{b / 1e9:9.1f}G {100 * b / max(total_b, 1):5.1f} "
              f"{100 * by_flops[tag] / max(total_f, 1):6.1f}  {_short(tag)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
