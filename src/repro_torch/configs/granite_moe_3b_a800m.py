"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8), 40
experts of width 512, top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-3b-a800m-base]

A copy of the JAX package's config.  Its widths are granite-3.0-3b-a800m's
(the JAX file's ``source`` names the 1b-a400m model, whose widths are
smaller); this copy names the model the widths belong to.  The reference
models none of granite's embedding, attention, residual or logit
multipliers, and the port follows the reference.

In int8 with packed checksums (``vocab_padded`` 49,408) the experts take
32 x 40 x (2 x 1536 x 640 + 512 x 1664) = 3,607,101,440 B, attention
226,492,416 B, the token table 75,890,688 B and the head 76,087,296 B:
~3.99 GB, which fits one 80 GB card."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                   # per-expert FFN width
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    moe_group=512,
    rope_theta=10000.0,
    train_accum=16,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)
