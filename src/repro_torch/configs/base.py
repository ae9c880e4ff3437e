"""Architecture + shape configuration schema."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense|moe|ssm|hybrid|encdec|vlm|dlrm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0           # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500000.0
    use_rope: bool = True
    gated_mlp: bool = True      # SwiGLU vs plain GeLU MLP
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_group: int = 1024
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    d_inner: int = 0            # mamba inner width (0 => 2*d_model)
    sliding_window: int = 0     # 0 => full attention everywhere
    global_layer_every: int = 0  # hymba: every k-th layer is global attn
    meta_tokens: int = 0
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500
    # --- VLM stub frontend ---
    patch_dim: int = 0          # vision feature dim fed to projector
    n_patches: int = 0          # patches prepended in train/prefill
    # --- runtime ---
    sub_quadratic: bool = False  # may run long_500k
    train_accum: int = 1         # gradient-accumulation microbatches
    attn_chunk: int = 1024
    wkv_chunk: int = 0           # chunked matmul-form WKV6 (rwkv; §Perf)
    ssm_chunk: int = 0           # two-level rematted mamba scan (hymba)
    deferred_grad_sync: bool = False  # shard_map manual data axis, one
    # int8+checksum grad collective per step (needs params+opt to fit
    # replicated over data — no ZeRO; EXPERIMENTS §Perf hillclimb 2)
    moe_token_parallel: bool = False  # replicate expert weights, shard the
    # expert-slot dim over `model`: collective-free MoE FFN for
    # small-expert archs (granite) — EXPERIMENTS §Perf hillclimb 2
    zero1: bool = False          # pure DP over all axes + flat ZeRO-1
    # optimizer shards (bf16 params must fit one chip) — hillclimb 2 winner
    seq_parallel: bool = False   # shard activation seq dim over `model`
    # between layers (Megatron-SP): divides the remat stash by TP degree
    source: str = ""             # provenance note

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 for clean TP sharding (DESIGN.md §5)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    def is_global_layer(self, i: int) -> bool:
        """Hymba-style: first/last + every k-th layer use full attention."""
        if self.sliding_window == 0:
            return True
        if self.global_layer_every <= 0:
            return False
        return (i == 0 or i == self.n_layers - 1
                or i % self.global_layer_every == 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
