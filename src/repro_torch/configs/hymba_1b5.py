"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads, 128 meta
tokens, sliding-window attention with 3 global layers.
[arXiv:2411.13676; hf]

Sub-quadratic (SWA + SSM) => runs long_500k.  25 heads / kv=5 do not divide
the mesh => attention projections replicate; the mamba branch (d_inner=3200)
shards on `model`."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    ssm_state=16,
    d_inner=3200,
    sliding_window=1024,
    global_layer_every=16,      # layers 0, 16, 31 ≈ the paper's 3 global
    meta_tokens=128,
    rope_theta=10000.0,
    sub_quadratic=True,
    train_accum=8,
    ssm_chunk=64,
    source="arXiv:2411.13676; hf",
)
