"""Architecture registry of the port: ``--arch <id>`` resolves here.

The paper's own DLRM, RWKV6-1.6B, the dense Llama-3.2-1B, Qwen3-8B and
InternLM2-20B, the MoE granite-moe-3b-a800m, the encoder-decoder
whisper-large-v3, the hybrid hymba-1.5b and the VLM
llava-next-mistral-7b are ported.
The other ids the JAX package knows are listed so that asking for one
says it is not ported yet, instead of claiming the id is unknown.
"""
from __future__ import annotations

from repro_torch.configs import (dlrm, granite_moe_3b_a800m, hymba_1b5,
                                 internlm2_20b, llama3_2_1b,
                                 llava_next_mistral_7b, qwen3_8b, rwkv6_1b6,
                                 whisper_large_v3)

ARCHS = {
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "hymba-1.5b": hymba_1b5.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "dlrm": dlrm.CONFIG,            # the paper's own architecture
}

#: ids of the JAX package's registry that wait for later slices of the
#: port, with the ROADMAP item that ports each
NOT_PORTED = {
    "mistral-large-123b": "A8.4 (tensor parallelism: its int8 weights "
                          "outgrow one card)",
    "llama4-scout-17b-a16e": "A8.4 (tensor parallelism: its int8 experts "
                             "alone are ~97 GB, over one card)",
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
