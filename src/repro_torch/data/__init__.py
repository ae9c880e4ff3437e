from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    Prefetcher,
    SyntheticDLRMDataset,
    SyntheticLMDataset,
    make_dataset,
)
