"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the paper's own DLRM is ported so far.  The other ids the JAX
package knows are listed so that asking for one says it is not ported
yet, instead of claiming the id is unknown.
"""
from __future__ import annotations

from repro_torch.configs import dlrm

ARCHS = {
    "dlrm": dlrm.CONFIG,            # the paper's own architecture
}

#: ids of the JAX package's registry whose model families wait for later
#: slices of the port (ROADMAP A8, A11)
NOT_PORTED = (
    "whisper-large-v3", "llama3.2-1b", "internlm2-20b", "qwen3-8b",
    "mistral-large-123b", "rwkv6-1.6b", "llama4-scout-17b-a16e",
    "granite-moe-3b-a800m", "hymba-1.5b", "llava-next-mistral-7b",
)


def get_arch(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP A8/A11); the port "
            f"serves {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
