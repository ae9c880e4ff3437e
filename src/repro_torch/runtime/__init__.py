"""Training runtime: the int8 error-feedback gradient compression with
its mod-8191 checked all-reduce, straggler telemetry and the
fault-tolerant loop (the JAX package's ``runtime``; its elastic re-mesh
waits for ROADMAP A8)."""
from repro_torch.runtime.compression import (  # noqa: F401
    CompressionState,
    checked_psum,
    compress_grads,
    decompress_grads,
    init_compression,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.loop import (  # noqa: F401
    LoopConfig,
    TrainLoop,
    metrics_to_host,
)
