"""Reduced-size configs (``serve --smoke`` and the tests): a copy
of the JAX package's ``configs/reduce.py::reduce_cfg``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def reduce_cfg(cfg: ArchConfig) -> ArchConfig:
    """Shrink an architecture to smoke-test size, keeping its family and
    structural quirks (GQA ratio, MoE top-k, SWA, meta tokens, frontend
    stubs).  For rwkv6-1.6b: 2 layers, d 64, 4 heads of 16, d_ff 128,
    vocab 97 padded to 256, ``wkv_chunk`` 16 unchanged."""
    kw = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=97,            # deliberately unaligned: exercises vocab padding
        head_dim=16,
        attn_chunk=8,
        train_accum=1,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.family == "moe":
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
        kw["moe_group"] = 16
    if cfg.family == "hybrid":
        kw["ssm_state"] = 4
        kw["d_inner"] = 128
        kw["sliding_window"] = 8
        kw["global_layer_every"] = 2
        kw["meta_tokens"] = 4
    if cfg.family == "encdec":
        kw["enc_layers"] = 2
        kw["enc_seq"] = 12
    if cfg.family == "vlm":
        kw["patch_dim"] = 24
        kw["n_patches"] = 6
    return dataclasses.replace(cfg, **kw)
