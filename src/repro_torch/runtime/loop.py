"""Fault-tolerant training loop (the JAX package's ``runtime/loop.py``).

    loop = TrainLoop(step_fn, dataset, cfg=LoopConfig(...))
    state, metrics = loop.run(state, n_steps)

Per step:
  1. the next batch from the seeded pipeline (a pure function of the
     step, so a restart regenerates the exact stream), cut to the rank's
     rows over a data mesh (``shardings``), moved to the state's device;
  2. the train step (grad accumulation, compression, AdamW; ABFT and
     ``comm/errors`` counters in its metrics), read on the host with one
     device-to-host copy;
  3. detect -> act: if the step's counters show errors, the policy:
       - ``log``: record and continue;
       - ``recompute``: re-run the same step from the pre-step state (one
         retry by default: an error striking twice is very rare);
       - ``restore``: reload the last checkpoint (persistent corruption);
  4. straggler telemetry;
  5. an async checksummed checkpoint every ``save_every`` steps.

``run`` resumes from the newest committed checkpoint.  The step function
must not update its input state in place: ``recompute`` re-runs from it.
With ``obs``, ``monitor`` and ``adapt`` each step lands in the
observability layer (a span, step counters, the per-op ABFT counters and
detection events through :func:`repro_torch.protect.observe_metrics`),
the detection-health monitor folds it, and the adaptive thresholds tick.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import shard_batch
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.loop")


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    save_every: int = 100
    keep_last: int = 3
    fault_policy: str = "recompute"   # log | recompute | restore
    max_recomputes_per_step: int = 1
    straggler_threshold: float = 2.0
    log_every: int = 10


def metrics_to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A step's metrics as Python numbers, every tensor in one
    device-to-host copy (as float64: exact for the int32 counters and the
    float32 losses)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: v for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().reshape(()).to(
            torch.float64) for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


def _batch_to(batch, device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


class TrainLoop:
    """Drives (state, batch) -> (state, metrics) with fault handling."""

    def __init__(self, step_fn: Callable, dataset, *, cfg: LoopConfig,
                 shardings=None, group=None,
                 metrics_hook: Optional[Callable] = None,
                 obs=None, monitor=None, adapt=None,
                 on_threshold: Optional[Callable] = None):
        self.step_fn = step_fn
        self.dataset = dataset
        self.cfg = cfg
        #: a data rank's rows of each batch
        #: (:class:`repro_torch.data.pipeline.BatchShard`), as JAX's
        #: loop places each batch with its ``shardings``
        self.shardings = shardings
        self.metrics_hook = metrics_hook
        if monitor is not None and obs is None:
            from repro_torch.obs import Observability
            obs = Observability.create()
        self.obs = obs
        #: detection-health Monitor fed by this loop's step summaries
        self.monitor = monitor
        if monitor is not None:
            monitor.bind(obs)
        #: AdaptiveThresholds ticked after each observed step; a moved
        #: bound goes to ``on_threshold(moved)``, which may return a
        #: replacement step_fn built against the new plan (``None`` keeps
        #: the current one: log-only adaptation)
        if adapt is not None and monitor is None:
            raise ValueError("adapt= needs monitor= (its sensor)")
        self.adapt = adapt
        self.on_threshold = on_threshold
        if adapt is not None:
            adapt.bind(obs)
        # a data group's replicated state: rank 0 writes, all restore
        self.ckpt = CheckpointManager(cfg.ckpt_dir,
                                      keep_last=cfg.keep_last,
                                      save_every=cfg.save_every,
                                      group=group)
        self.straggler = StragglerMonitor(threshold=cfg.straggler_threshold)
        self.stats = {"recomputes": 0, "restores": 0, "faulty_steps": 0}

    #: legacy alias keys FaultReport.as_metrics emits NEXT TO the keyed
    #: counters (gemm = qgemm + float_gemm, eb = embedding_bag): summing
    #: them alongside the keyed set would double-count
    _LEGACY_ALIASES = ("abft/gemm_errors", "abft/eb_errors")

    def _errors_in(self, host: Dict[str, Any]) -> int:
        """The step's detected errors from its host metrics; ceiled, as
        grad-accumulation averages a single detection to a fraction
        (0.25 with accum 4)."""
        keyed = [k for k in host
                 if k.startswith("abft/") and k.endswith("_errors")
                 and k not in self._LEGACY_ALIASES]
        keys = keyed or [k for k in self._LEGACY_ALIASES if k in host]
        keys += [k for k in ("comm/errors",) if k in host]
        return int(math.ceil(sum(float(host[k]) for k in keys)))

    def _observe_step(self, step: int, host, dur_s: float) -> None:
        """One trained step lands in the obs layer (span, step counters,
        per-op ABFT counters, detection events)."""
        if self.obs is None:
            return
        from repro_torch.protect.runtime import observe_metrics
        now = self.obs.tracer.now_s()
        self.obs.tracer.add_span("train_step", cat="runtime",
                                 start_s=now - dur_s, dur_s=dur_s,
                                 step=step)
        self.obs.registry.counter(
            "repro_steps_total", "executed steps by kind and source"
        ).inc(1, kind="train", source="runtime.loop")
        self.obs.registry.histogram(
            "repro_step_duration_ms", "step wall time (ms)"
        ).observe(1e3 * dur_s, kind="train")
        observe_metrics(host, source="runtime.loop", step=step, t_s=now,
                        obs=self.obs, attrs={"kind": "train",
                                             "duration_ms": 1e3 * dur_s})

    def _restore(self, state):
        return self.ckpt.restore_latest(state)

    def run(self, state, n_steps: int, *, start_step: Optional[int] = None,
            resume: bool = True):
        """Run to ``n_steps`` (absolute).  Batches go to the device of
        the state's first leaf.  Returns (state, last metrics on the
        host)."""
        device = tree_leaves(state)[0].device
        step = 0 if start_step is None else start_step
        if resume:
            restored = self._restore(state)
            if restored is not None:
                state, step = restored
                log.info("resumed from checkpoint at step %d", step)

        host: Dict[str, Any] = {}
        while step < n_steps:
            batch = self.dataset.batch_at(step)
            if self.shardings is not None:
                batch = shard_batch(batch, self.shardings)
            batch = _batch_to(batch, device)
            self.straggler.step_start()
            pre_state = state
            t_step = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            host = metrics_to_host(metrics)

            errs = self._errors_in(host)
            # observe the PRE-policy metrics: a recompute that clears the
            # flag must not erase the detection from the event stream
            self._observe_step(step, host, time.perf_counter() - t_step)
            if self.adapt is not None and self.monitor is not None:
                moved = self.adapt.tick(self.monitor,
                                        t_s=self.obs.tracer.now_s()
                                        if self.obs else 0.0, step=step)
                if moved and self.on_threshold is not None:
                    new_fn = self.on_threshold(moved)
                    if new_fn is not None:
                        self.step_fn = new_fn
            if errs:
                self.stats["faulty_steps"] += 1
                if self.cfg.fault_policy == "recompute":
                    for _ in range(self.cfg.max_recomputes_per_step):
                        self.stats["recomputes"] += 1
                        # drop the faulty result before the re-run: at
                        # full width a third state does not fit
                        state = metrics = None
                        state, metrics = self.step_fn(pre_state, batch)
                        host = metrics_to_host(metrics)
                        if self._errors_in(host) == 0:
                            break
                    else:
                        log.warning(
                            "step %d still faulty after recompute", step)
                elif self.cfg.fault_policy == "restore":
                    restored = self._restore(state)
                    if restored is not None:
                        state, step = restored
                        self.stats["restores"] += 1
                        continue
                # "log": fall through

            self.straggler.step_end(step)
            step += 1
            self.ckpt.maybe_save(step, state)
            if self.metrics_hook and step % self.cfg.log_every == 0:
                self.metrics_hook(step, host)

        self.ckpt.maybe_save(step, state, force=True)
        self.ckpt.wait()
        return state, host
