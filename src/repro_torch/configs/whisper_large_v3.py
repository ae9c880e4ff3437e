"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed.

32L (x2: encoder+decoder stacks) d_model=1280 20H (kv=20 — effectively MHA)
d_ff=5120 vocab=51866.  [arXiv:2212.04356; unverified]

The mel/conv frontend is a STUB: ``input_specs`` feeds precomputed frame
embeddings [B, 1500, 1280].  20 heads do not divide the 16-wide `model` mesh
axis, so attention projections replicate under TP (DESIGN.md §5); MLP and
vocab dims shard.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    use_rope=False,             # sinusoid (enc) + learned (dec) positions
    gated_mlp=False,            # GeLU MLP
    rope_theta=10000.0,
    train_accum=8,
    source="arXiv:2212.04356; unverified",
)
