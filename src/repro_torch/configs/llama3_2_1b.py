"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]

A copy of the JAX package's config: Llama 3's rope scaling and tied
embeddings are not in it, so the port has neither."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    train_accum=4,
    head_dim=64,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
