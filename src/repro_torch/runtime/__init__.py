"""Training runtime: the int8 error-feedback gradient compression with
its mod-8191 checked all-reduce, straggler telemetry, the fault-tolerant
loop and the elastic re-mesh of a data-parallel world (the JAX package's
``runtime``).  A re-mesh re-cuts a data-parallel world (model axis 1);
a model mesh's state is saved whole and re-cut to its placements by the
checkpoint (:mod:`repro_torch.checkpoint`)."""
from repro_torch.runtime.compression import (  # noqa: F401
    CompressionState,
    checked_psum,
    compress_grads,
    decompress_grads,
    init_compression,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    plan_remesh,
    remesh_state,
)
from repro_torch.runtime.loop import (  # noqa: F401
    LoopConfig,
    TrainLoop,
    metrics_to_host,
)
