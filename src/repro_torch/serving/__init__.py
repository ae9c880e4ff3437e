"""``repro_torch.serving`` — the protected serving engine of the port.

Seeded DLRM request streams (Poisson / bursty / trace arrivals) flow
through an admission queue into per-plan lanes; a
:class:`ServingEngine` runs the protected DLRM forward per request and
its telemetry merges SLO percentiles with the op-keyed fault counters.

    from repro_torch.serving import ServingEngine, TenantSpec, dlrm_stream
    engine = ServingEngine(cfg, [TenantSpec("default", plan)])
    telemetry = engine.run(dlrm_stream(8, tenants={"default": 1.0},
                                       table_rows=4_000_000))
"""
from repro_torch.serving.batcher import ContinuousBatcher, Slot
from repro_torch.serving.engine import (ServingEngine, TenantSpec,
                                        tenant_weights)
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.telemetry import (InjectionRecord, RequestRecord,
                                           StepEvent, Telemetry,
                                           percentiles_ms)
from repro_torch.serving.workload import (ARRIVALS, Request, bursty_arrivals,
                                          dlrm_stream, make_arrivals,
                                          poisson_arrivals, sample_tenants,
                                          trace_arrivals)

__all__ = [
    "ServingEngine", "TenantSpec", "tenant_weights",
    "ContinuousBatcher", "Slot", "AdmissionQueue",
    "Telemetry", "RequestRecord", "StepEvent", "InjectionRecord",
    "percentiles_ms",
    "Request", "ARRIVALS", "dlrm_stream", "make_arrivals",
    "poisson_arrivals", "bursty_arrivals", "trace_arrivals",
    "sample_tenants",
]
