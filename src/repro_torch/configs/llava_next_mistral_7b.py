"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]

The vision tower is a STUB: ``input_specs`` feeds precomputed patch features
[B, 576, 1024] (one anyres tile); the 2-layer MLP projector into d_model is
real (and ABFT-protected).  Text backbone = mistral-7b."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    patch_dim=1024,
    n_patches=576,
    rope_theta=1000000.0,
    train_accum=8,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
