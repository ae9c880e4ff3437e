"""rwkv6-1.6b "Finch" [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay.  [arXiv:2404.05892; unverified]

Attention-free => O(1) decode state.  The WKV recurrence is not a GEMM,
so the paper's ABFT covers only the projections and the token embedding.
Prefill runs the recurrence in its chunked matmul form (``wkv_chunk``),
which the CUDA kernel K4 computes on the card."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # wkv heads (dh = 64)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    use_rope=False,
    sub_quadratic=True,
    train_accum=4,
    wkv_chunk=16,
    source="arXiv:2404.05892; unverified",
)
