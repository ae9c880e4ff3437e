from repro_torch.data.pipeline import (  # noqa: F401
    BatchShard,
    DataConfig,
    Prefetcher,
    SyntheticDLRMDataset,
    SyntheticLMDataset,
    make_dataset,
    shard_batch,
)
