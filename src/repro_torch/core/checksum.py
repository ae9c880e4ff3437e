"""Mod-checksums over parameter trees — the paper's philosophy applied to
the framework substrate (checkpoints and collectives).

A tensor's checksum is the mod-M sum of its byte view; a tree checksum is
the dict of per-leaf checksums, leaves in the JAX package's flatten order.
Pure integer arithmetic => exact, cheap, dtype-agnostic.  Each sum wraps
where the JAX package's does (its byte sum is uint32, its value sum
int32), so both packages give the same checksum of the same bytes.
"""
from __future__ import annotations

import torch

MOD_U32 = 2147483647  # 2^31 - 1 (Mersenne prime)


def _wrap(x: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """An int64 tensor reduced to ``bits``-bit two's complement."""
    x = x & ((1 << bits) - 1)
    if signed:
        x = torch.where(x >= (1 << (bits - 1)), x - (1 << bits), x)
    return x


def tensor_checksum(x: torch.Tensor) -> torch.Tensor:
    """Mod-(2^31-1) sum of the uint8 byte view (int64 scalar): the byte
    sum wraps at 2^32 first, as a uint32 sum does."""
    u8 = x.contiguous().reshape(-1).view(torch.uint8)
    total = _wrap(torch.sum(u8, dtype=torch.int64), 32, signed=False)
    return total % MOD_U32


def int_payload_checksum(x: torch.Tensor,
                         mod: int = 2147483647) -> torch.Tensor:
    """Value (not byte) checksum — additive across an integer all-reduce.

    An int64 payload sums its residues in int64; any other integer type
    is taken as int32 and its residues summed with int32 wrap-around."""
    if x.dtype == torch.int64:
        return torch.sum(x % mod) % mod
    r = x.to(torch.int32).to(torch.int64) % mod
    return _wrap(torch.sum(r), 32, signed=True) % mod


def tree_checksum(tree) -> dict:
    from repro_torch.core.inject import leaf_paths
    return {f"leaf_{i}": tensor_checksum(leaf)
            for i, (_, leaf) in enumerate(leaf_paths(tree))}


def verify_tree(tree, expected: dict) -> bool:
    got = tree_checksum(tree)
    return all(int(got[k]) == int(expected[k]) for k in expected)
