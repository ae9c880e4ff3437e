"""Architecture registry of the port: ``--arch <id>`` resolves here.

The paper's own DLRM, RWKV6-1.6B, Llama-3.2-1B, Qwen3-8B and the MoE
granite-moe-3b-a800m are ported.
The other ids the JAX package knows are listed so that asking for one
says it is not ported yet, instead of claiming the id is unknown.
"""
from __future__ import annotations

from repro_torch.configs import (dlrm, granite_moe_3b_a800m, llama3_2_1b,
                                 qwen3_8b, rwkv6_1b6)

ARCHS = {
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "dlrm": dlrm.CONFIG,            # the paper's own architecture
}

#: ids of the JAX package's registry that wait for later slices of the
#: port, with the ROADMAP item that ports each
NOT_PORTED = {
    "internlm2-20b": "A7 (the remaining configs)",
    "mistral-large-123b": "A8 (sharding: its int8 weights outgrow one card)",
    "llama4-scout-17b-a16e": "A8 (sharding: its int8 experts alone are "
                             "~97 GB, over one card)",
    "whisper-large-v3": "A7 (other model families)",
    "hymba-1.5b": "A7 (other model families)",
    "llava-next-mistral-7b": "A7 (other model families)",
}


def get_arch(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]}); "
            f"the port serves {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
