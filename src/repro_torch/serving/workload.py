"""Request-stream generators for the serving engine.

A workload is a finite, seeded list of :class:`Request` s sorted by arrival
time.  Arrival processes model the traffic shapes Ma et al. (arXiv
2307.10244) show matter for error impact — steady Poisson, bursty
on/off, and trace replay — and two request kinds ride on them:

* ``chat`` — LM requests with sampled prompt/output lengths (lognormal,
  clipped), served by the continuous batcher (prefill + N decode steps);
* ``dlrm`` — one-shot recommendation lookups whose payload reuses the
  padded multi-hot layout of the JAX package's synthetic DLRM dataset
  (``dense [B, n_dense]``, ``bags [n_tables, B, max_pool]`` with −1 pads).

A copy of ``repro.serving.workload`` with its imports moved to the port:
the same seed gives the same stream in both packages.

Everything is a pure function of the seed: a soak re-run regenerates the
exact request stream, so faulty and clean runs are step-for-step
comparable (the campaign's masked/SDC ground truth depends on this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

ARRIVALS = ("poisson", "bursty", "trace")


@dataclasses.dataclass
class Request:
    """One inference request.  ``payload`` is filled lazily for chat
    requests (the engine synthesizes prompt tokens from ``seed``) and
    eagerly for dlrm lookups (numpy arrays)."""
    rid: int
    tenant: str
    arrival_s: float
    kind: str = "chat"                  # "chat" | "dlrm"
    prompt_len: int = 32
    max_new_tokens: int = 16
    seed: int = 0
    payload: Optional[dict] = None
    #: shared system-prompt prefix: the first ``prefix_len`` prompt tokens
    #: are drawn from ``prefix_seed`` instead of ``seed``, so every
    #: request carrying the same (prefix_seed, prefix_len) opens with
    #: byte-identical tokens — the paged KV cache's prefix tree serves
    #: those pages from shared, already-checksummed storage
    prefix_len: int = 0
    prefix_seed: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("chat", "dlrm"):
            raise ValueError(f"unknown request kind {self.kind!r}")


# ------------------------------ arrivals ------------------------------------

def poisson_arrivals(rate_rps: float, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """n arrival offsets (seconds) of a Poisson process at ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


def bursty_arrivals(rate_rps: float, n: int, rng: np.random.Generator, *,
                    burst_size: int = 8,
                    burst_spread_s: float = 1e-3) -> np.ndarray:
    """On/off traffic: requests arrive in bursts of ``burst_size`` whose
    *burst* starts form a Poisson process at ``rate_rps / burst_size``
    (same long-run rate as the Poisson stream, very different queueing)."""
    n_bursts = -(-n // burst_size)
    starts = poisson_arrivals(rate_rps / burst_size, n_bursts, rng)
    times = (starts[:, None]
             + rng.uniform(0.0, burst_spread_s, (n_bursts, burst_size)))
    return np.sort(times.reshape(-1)[:n])


def trace_arrivals(trace: Sequence[float], n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Replay recorded arrival offsets, tiling (with the trace span as the
    period) when the trace is shorter than ``n``."""
    t = np.asarray(sorted(float(x) for x in trace), np.float64)
    if t.size == 0:
        raise ValueError("empty trace")
    del rng
    span = max(float(t[-1]), 1e-9)
    reps = -(-n // t.size)
    tiled = np.concatenate([t + i * span for i in range(reps)])
    return tiled[:n]


def make_arrivals(pattern: str, rate_rps: float, n: int,
                  rng: np.random.Generator, *,
                  trace: Optional[Sequence[float]] = None,
                  burst_size: int = 8) -> np.ndarray:
    if pattern == "poisson":
        return poisson_arrivals(rate_rps, n, rng)
    if pattern == "bursty":
        return bursty_arrivals(rate_rps, n, rng, burst_size=burst_size)
    if pattern == "trace":
        if trace is None:
            raise ValueError("pattern 'trace' needs a trace")
        return trace_arrivals(trace, n, rng)
    raise ValueError(f"unknown arrival pattern {pattern!r}; "
                     f"have {ARRIVALS}")


# ------------------------------ tenants -------------------------------------

def sample_tenants(weights: Dict[str, float], n: int,
                   rng: np.random.Generator) -> List[str]:
    names = sorted(weights)
    w = np.asarray([weights[t] for t in names], np.float64)
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"bad tenant weights {weights!r}")
    return [names[i] for i in rng.choice(len(names), size=n, p=w / w.sum())]


def _clipped_lognormal(rng, mean: float, sigma: float, lo: int,
                       hi: int, size: int) -> np.ndarray:
    x = rng.lognormal(np.log(max(mean, 1)), sigma, size)
    return np.clip(np.round(x), lo, hi).astype(np.int64)


# ------------------------------ streams -------------------------------------

def chat_stream(n: int, *, tenants: Dict[str, float], rate_rps: float = 20.0,
                arrival: str = "poisson", seed: int = 0,
                mean_prompt: int = 32, max_prompt: int = 64,
                mean_output: int = 12, max_output: int = 32,
                trace: Optional[Sequence[float]] = None,
                burst_size: int = 8, prefix_len: int = 0,
                prefix_seed: Optional[int] = None) -> List[Request]:
    """LM chat request stream with sampled prompt/output lengths.

    ``prefix_len``/``prefix_seed`` give every request the same opening
    system prompt (prompt lengths are floored at ``prefix_len`` so the
    prefix is always fully present)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4A7]))
    times = make_arrivals(arrival, rate_rps, n, rng, trace=trace,
                          burst_size=burst_size)
    who = sample_tenants(tenants, n, rng)
    plens = _clipped_lognormal(rng, mean_prompt, 0.4, 4, max_prompt, n)
    olens = _clipped_lognormal(rng, mean_output, 0.5, 1, max_output, n)
    if prefix_len > 0:
        plens = np.maximum(plens, min(prefix_len, max_prompt))
    return [Request(rid=i, tenant=who[i], arrival_s=float(times[i]),
                    kind="chat", prompt_len=int(plens[i]),
                    max_new_tokens=int(olens[i]),
                    seed=int(rng.integers(0, 2**31 - 1)),
                    prefix_len=prefix_len if prefix_seed is not None else 0,
                    prefix_seed=prefix_seed)
            for i in range(n)]


def dlrm_stream(n: int, *, tenants: Dict[str, float], rate_rps: float = 50.0,
                arrival: str = "poisson", seed: int = 0,
                lookup_batch: int = 10, table_rows: int = 1000,
                n_tables: Optional[int] = None,
                max_pool: int = 16,
                trace: Optional[Sequence[float]] = None,
                burst_size: int = 8) -> List[Request]:
    """One-shot DLRM lookup requests.  Payload shapes follow the JAX
    package's synthetic DLRM dataset: ``dense [B, n_dense]`` f32 and
    ``bags [n_tables, B, max_pool]`` int32 with −1 padding and variable
    pooling."""
    from repro_torch.configs.dlrm import EXTRAS

    nt = EXTRAS.n_tables if n_tables is None else n_tables
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD12A]))
    times = make_arrivals(arrival, rate_rps, n, rng, trace=trace,
                          burst_size=burst_size)
    who = sample_tenants(tenants, n, rng)
    out = []
    for i in range(n):
        dense = rng.standard_normal(
            (lookup_batch, EXTRAS.n_dense)).astype(np.float32)
        pools = rng.integers(1, max_pool + 1, (nt, lookup_batch))
        idx = rng.integers(0, table_rows, (nt, lookup_batch, max_pool))
        mask = np.arange(max_pool)[None, None, :] < pools[..., None]
        bags = np.where(mask, idx, -1).astype(np.int32)
        out.append(Request(
            rid=i, tenant=who[i], arrival_s=float(times[i]), kind="dlrm",
            prompt_len=0, max_new_tokens=0,
            seed=int(rng.integers(0, 2**31 - 1)),
            payload={"dense": dense, "bags": bags}))
    return out


def stream_span_s(requests: Sequence[Request]) -> float:
    return max((r.arrival_s for r in requests), default=0.0)


__all__ = ["Request", "ARRIVALS", "poisson_arrivals", "bursty_arrivals",
           "trace_arrivals", "make_arrivals", "sample_tenants",
           "chat_stream", "dlrm_stream", "stream_span_s"]
