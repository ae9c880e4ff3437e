"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every id of the JAX package's registry: the paper's own DLRM, RWKV6-1.6B,
the dense Llama-3.2-1B, Qwen3-8B, InternLM2-20B and Mistral-Large-123B,
the MoEs granite-moe-3b-a800m and Llama-4-Scout-17B-16E, the
encoder-decoder whisper-large-v3, the hybrid hymba-1.5b and the VLM
llava-next-mistral-7b.  The dry run (:mod:`repro_torch.launch.dryrun`)
reckons every one of them on a meta mesh.  Every id is served and
trained like any other (reduced with ``--smoke``, cut in depth on the
card); the two in :data:`SHARDED_ONLY` do not fit one card at full
depth.
"""
from __future__ import annotations

from repro_torch.configs import (dlrm, granite_moe_3b_a800m, hymba_1b5,
                                 internlm2_20b, llama3_2_1b,
                                 llama4_scout_17b_a16e,
                                 llava_next_mistral_7b, mistral_large_123b,
                                 qwen3_8b, rwkv6_1b6, whisper_large_v3)

ARCHS = {
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "hymba-1.5b": hymba_1b5.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "dlrm": dlrm.CONFIG,            # the paper's own architecture
}

#: ids that do not fit one card at full depth, and why: the card runs
#: them cut in depth (``chip_smoke.DEPTH``), a mesh's model axis whole
SHARDED_ONLY = {
    "mistral-large-123b": "its int8 weights are ~123 GB",
    "llama4-scout-17b-a16e": "its int8 experts alone are ~97 GB",
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
