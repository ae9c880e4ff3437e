"""The paper's own architecture: DLRM (quantized, ABFT-protected).

Bottom MLP over dense features, 26 quantized embedding tables with multi-hot
EmbeddingBag lookups (pooling 100 — Table I), dot-product feature
interaction, top MLP -> CTR logit.  Table geometry follows the paper's EB
evaluation (4M rows); the GEMM shapes exercised by benchmarks/gemm_overhead
follow Fig. 5."""
import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DlrmExtras:
    n_dense: int = 13
    bottom_mlp: tuple = (512, 256, 128)
    n_tables: int = 26
    table_rows: int = 4_000_000
    emb_dim: int = 128
    pooling: int = 100
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    batch: int = 10             # paper Table I batch size


CONFIG = ArchConfig(
    name="dlrm",
    family="dlrm",
    n_layers=0,
    d_model=128,                # = emb_dim (interaction width)
    vocab=0,
    source="paper §VI (Fig. 5, Table I)",
)

EXTRAS = DlrmExtras()
