"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

16 experts divide the 16-wide `model` axis exactly => expert-parallel.
40 heads do not divide 16 => attention projections replicate under TP
(experts dominate FLOPs).  Shared expert / early-fusion omitted (not in the
assigned config line)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,                  # per-expert FFN width
    vocab=202048,
    head_dim=128,
    n_experts=16,
    top_k=1,
    moe_group=2048,
    rope_theta=500000.0,
    train_accum=16,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
