"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

The largest assigned cell: training runs with 8-way gradient accumulation +
scan-remat to fit 16 GB/chip on the (16,16) mesh (verified by the dry-run's
memory_analysis)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    rope_theta=1000000.0,
    train_accum=16,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
