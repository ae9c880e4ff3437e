"""``repro_torch.serving`` — the protected serving engine of the port.

Seeded request streams (Poisson / bursty / trace arrivals) flow through
an admission queue into per-plan lanes; a :class:`ServingEngine` runs
the protected DLRM forward per lookup, or RWKV6 prefill and batched
decode per chat request, and its telemetry merges SLO percentiles with
the op-keyed fault counters.

    from repro_torch.serving import ServingEngine, TenantSpec, chat_stream
    engine = ServingEngine(get_arch("rwkv6-1.6b"), [TenantSpec("default")])
    telemetry = engine.run(chat_stream(8, tenants={"default": 1.0}))
"""
from repro_torch.serving.batcher import ContinuousBatcher, Slot
from repro_torch.serving.engine import (FaultInjection, ServingEngine,
                                        TenantSpec, tenant_weights)
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.telemetry import (InjectionRecord, RequestRecord,
                                           StepEvent, Telemetry,
                                           percentiles_ms)
from repro_torch.serving.workload import (ARRIVALS, Request, bursty_arrivals,
                                          chat_stream, dlrm_stream,
                                          make_arrivals,
                                          poisson_arrivals, sample_tenants,
                                          trace_arrivals)

__all__ = [
    "ServingEngine", "TenantSpec", "FaultInjection", "tenant_weights",
    "ContinuousBatcher", "Slot", "AdmissionQueue",
    "Telemetry", "RequestRecord", "StepEvent", "InjectionRecord",
    "percentiles_ms",
    "Request", "ARRIVALS", "chat_stream", "dlrm_stream", "make_arrivals",
    "poisson_arrivals", "bursty_arrivals", "trace_arrivals",
    "sample_tenants",
]
