#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--out details.json]

Six paths run, each with every launch counter set to 0 just before it
and read just after: the paper's int8 DLRM serving (kernels K1-K3), int8
RWKV6-1.6B chat serving (K1-K4), the main-path resilience campaign (K1,
K2), the ``thresholds`` grid (K2), the paper's overhead benchmarks (K1,
K2 and their unprotected instances) and the float DLRM converted to int8
(K1-K3).  Phases (any failure exits non-zero; nothing is caught and
passed over):

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the four CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build times;
3. make the full-width DLRM (26 tables x 4M rows x 128 int8, random
   weights from a seed) on the card and hold each kernel against its
   plain PyTorch version at the main path's shapes and at one larger
   shape: integers bit-exact, floats within the stated tolerance, and a
   flipped weight bit and a flipped high table bit flagged exactly as the
   plain version flags them.  K1 runs every layer in int8 and uint8, with
   and without the column check, plus an aligned RWKV shape split across
   a cluster and an operand off 16-byte alignment; K3 every layer width
   in bf16 (the path's type) and f32.  K1 is launched as the
   programmatic dependent of the kernel before it, so it is also held
   bit-exact right after K3, right after an in-place flip of a B' byte,
   right after another K1 on the same scratch and right after the
   ``correct`` policy's repair.  K2 on one request's bags and on the
   paper's Table I pooling (26 x 2048 bags x 100): R bit-exact with the
   slot-order sum of the plain terms (also for indices past the table),
   rsum within 1e-5 of d x max|R|, flags and counts equal to the plain
   branch at rel_bound 1e-3 and 1e-5 and to K2's formula on its own
   rsum at 1e-3, 1e-5 and 1e-7; each of the 8 bits of a table byte
   flipped, flagged as the plain branch flags it; and, as a programmatic
   dependent, right after an in-place table flip, an alpha change and
   another K2 on the same output allocation and counters;
4. serve 8 ``dlrm_stream`` requests through ``ServingEngine`` under the
   default plan: every request completes, all fault counters are 0, every
   kernel launched; then faults through the engine's ``FaultInjection``:
   a transient flip of ``top.0``'s packed weight, a high bit of a table
   row the request gathers, and a persistent ``top.0`` flip, each flagged
   at its step (the persistent one at every later request) and each
   victim leaf bit-identical afterwards (by fingerprint); the full-width
   logits must be finite, and a small model's forward on the card must
   agree with the plain forward on the CPU (1% of the logit scale, same
   fault counters);
5. count the device operations of one protected EmbeddingBag call by
   the profiler (K2 alone in the card branch, at most 2 with the protect
   layer's sum); time each kernel, its plain version and (for K1)
   ``torch._int_mm`` by CUDA events at the main path's shapes (K2 on
   cold rows and at Table I), next to the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate; for K2 also with each random scale load a 32-byte sector),
   the time K3 adds in front of K1 (K3 -> K1 against K1 alone over a
   request's layers), and the per-request serve latency; K3 and K4 must
   be handed the path's bf16 activations, with no cast before them;
6. make the full-width RWKV6-1.6B (24 layers, d 2048, 32 heads of 64,
   d_ff 7168, vocab 65536; random int8 weights from a seed) on the card
   and hold K1 and K3 (bit-exact; K3 on bf16 and f32) at its four GEMM
   shapes, K1 under PDL in the four positions of phase 3, K2 on its
   65536 x 2048 token table at 64 and 4 tokens (the checks and PDL
   positions of phase 3, and its time on cold rows beside both bounds),
   and K4 (within 2e-4, and within 2e-4 of the
   per-token recurrence) on the prefill's own bf16 inputs of every layer
   and at batch 1 and 2, dh 64 and 32, chunk 16 and 8, on heavy-decay
   random inputs and on the all-``LOG_W_MIN`` worst case, in bf16 and
   f32, staged by 16- and by 4-byte copies;
7. serve 8 ``chat_stream`` requests (prompt 64, up to 32 new tokens, 4
   slots) under the default plan: every request completes, all fault
   counters are 0, K4 launched 24 times per prefill (the warm-up's
   included); ``FaultInjection`` flips of a ``cm.wv`` payload bit and of
   a high bit of a prompt token's embedding row are each flagged at their
   step and the leaves restored bit for bit; the smoke-size RWKV's
   prefill and 3 decode steps on the card agree with the plain run on
   the CPU at a 64- and at a 24-token prompt (off the WKV chunk grid: K4
   on the first 16 tokens, the recurrence on the rest): the same
   counters; where an activation's int8 codes first differ, a rounding
   split, printed; run free, logits within 1e-4 of their scale up to that
   split (and in bf16 within 2**-4 after it); run in lockstep, the CPU
   taking the card's codes at each rounding split, within 1e-4 at every
   step; and the
   smoke-size engines at a 24-token bucket serve the same requests with
   the same counters on the card and on the CPU;
8. time K4 and its plain version at the prefill shape (r, k, v in bf16
   and f32) and at (4, 4096, 32, 64); K1 at each GEMM shape of a step
   with its weights
   cold (cycling the layers) and warm, beside ``torch._int_mm`` on the
   same cold weights and the byte bound, and under every split count of
   its cluster (the evidence for the plan's rule); K3 at each shape, and
   K3 -> K1 against K1 alone on the same cold weights; the
   prefill and decode steps, and the device-busy and K1 shares of a few
   served requests;
9. run the port's ``quick``, ``pallas`` (quick) and ``paper`` campaign
   grids on the card through K1 and K2 at the JAX grids' sample counts,
   seed 0 (artifacts beside ``--out``); every main-path cell of the
   committed ``BENCH_campaign_pallas_quick.json`` (7) and
   ``BENCH_campaign_quick.json`` (10) baselines must overlap its baseline
   by 95% Wilson interval in detection and in false positives; the
   port's differ record against both is printed, with the cells where its
   ``det_tol`` 0.02 verdict disagrees with the Wilson gate; each cell's
   rates, overhead and phase times (CUDA events) are printed; K1 and K2
   are held to their plain versions at every shape the grids hand them
   (K1 bit-exact, clean and with a fault in B'; K2 as in phase 3); and
   every cell that launches K1 or K2, run with the kernels and with its
   plain versions from one seed, must decide every trial alike: the
   GEMM's bit for bit, the EmbeddingBag's but for at most 1% of its
   trials, each within float32 round-off of the bound and shown to be
   K2's own formula on an rsum within round-off of the float64 sum;
10. run the port's ``thresholds`` grid on the card (15 EB cells,
   rel_bound 1e-7 to 1e-3, 400 faulty and 400 clean trials, seed 0) and
   print its tradeoff curve: detection must overlap the committed JAX
   baseline by Wilson interval in every cell, FP at 1e-6 to 1e-3; at 1e-7
   (ROADMAP §C2: round-off decides clean bags) the FP rate is printed
   beside the baseline's and the plain branch's, and every trial is
   replayed through K2 with its flags held bag for bag to K2's own Eq. (5)
   formula on its own rsum;
11. run the paper's overhead benchmarks (``repro_torch.benchmarks``):
   Fig. 5 over the 28 DLRM GEMM shapes (K1, cold and warm, and with the
   encoding, against K1's unprotected instance) and Table I at d 32-256
   on 4M-row tables (K2 against its unprotected instance, fresh indices
   every launch), by CUDA events in alternating rounds; print both tables
   in full; the unprotected instances bit-exact to the protected kernels
   (C's first n columns, R) and to their plain versions, and no median
   overhead below -5%;
12. the full-width float DLRM over phase 3's tables, 8 batches of
   ``SyntheticDLRMDataset``: ``float_gemm`` on, 0 errors clean; a flipped
   exponent bit of a ``top.0`` weight flagged at ``top.0`` and nowhere
   else, and 0 errors once restored; converted by ``quantize_dlrm`` and
   served on the same batches through K1-K3 with 0 errors; the float vs
   int8 CTR gap printed.

The line before the last is ``{"kernels": [...]}``: K1-K4 and the two
unprotected instances; ``launches`` is the count of the kernel's own path
(DLRM for K1-K3, RWKV for K4, the overhead benchmarks for the unprotected
instances), and ``launches_by_path`` holds every kernel's count on each
of the six paths (DLRM serve, RWKV serve, campaign, thresholds, overhead,
float DLRM), all six counts set to 0 just before each path and read just
after.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository's ``src/`` beside this
file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the pl.pallas_call of each TPU kernel
REPLACES = {
    "abft_qgemm": "src/repro/kernels/abft_qgemm.py:237",
    "abft_embeddingbag": "src/repro/kernels/abft_embeddingbag.py:67",
    "quantize_rows": "src/repro/kernels/quantize_rows.py:42",
    "wkv6_chunked": "src/repro/kernels/wkv6_chunked.py:99",
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


def all_wrappers() -> dict:
    """Every kernel's wrapper, by name: K1-K4 and the two unprotected
    instances the overhead benchmarks time."""
    from repro_torch.kernels.abft_embeddingbag import (abft_eb_cuda,
                                                       eb_unprotected_cuda)
    from repro_torch.kernels.abft_qgemm import (abft_qgemm_cuda,
                                                 qgemm_unprotected_cuda)
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda
    return {"abft_qgemm": abft_qgemm_cuda,
            "abft_embeddingbag": abft_eb_cuda,
            "quantize_rows": quantize_rows_cuda,
            "wkv6_chunked": wkv6_chunked_cuda,
            "qgemm_unprotected": qgemm_unprotected_cuda,
            "eb_unprotected": eb_unprotected_cuda}


def zero_launches() -> dict:
    """:func:`all_wrappers` with every launch count set to 0: called just
    before a path is driven."""
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    """The launch count of each of ``wrappers`` (:func:`zero_launches`'
    result), read just after the path."""
    return {k: w.launches for k, w in wrappers.items()}


def profile_requests(torch, engine, requests) -> dict:
    """Where a request's time goes: device time by kernel over a few served
    requests, against the requests' own wall time (the engine's step
    durations, so the profiler's start and stop are not counted).  A
    diagnostic only: where the profiler cannot trace the card it says so
    and the run goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tel = engine.run(requests, warmup=False)
            torch.cuda.synchronize()
        wall_ms = sum(ev.duration_s for ev in tel.steps) * 1e3
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue                # CPU ops; their kernels are listed
            t_us = getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0))
            if t_us > 0:
                by_name[ev.key] = (t_us / 1e3, ev.count)
    except Exception as e:              # noqa: BLE001 - diagnostic only
        log(f"profiler could not trace the card: {e!r}")
        return {"error": repr(e)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    device_ms = sum(t for t, _ in by_name.values())
    k1_ms = sum(t for k, (t, _) in by_name.items() if "abft_qgemm_kernel" in k)
    ours = {name: [sum(v[i] for k, v in by_name.items() if name in k)
                   for i in (0, 1)]
            for name in ("abft_qgemm_kernel", "abft_eb_kernel",
                         "quantize_rows_kernel", "wkv6_chunked_kernel")}
    out = {"requests": len(requests), "wall_ms": wall_ms,
           "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None,
           "k1_ms": k1_ms,
           "k1_share": k1_ms / device_ms if device_ms else None,
           "kernels_per_request": sum(c for _, c in by_name.values())
           / len(requests),
           "ours_ms_and_count": ours,
           "top": [{"name": k, "ms": t, "count": c} for k, (t, c) in top]}
    log(f"profile of {len(requests)} requests: device {device_ms:.3f} ms of "
        f"{wall_ms:.3f} ms of request wall time, K1 {k1_ms:.3f} ms of it; "
        f"top: "
        + "; ".join(f"{k[:48]} {t:.3f}ms x{c}" for k, (t, c) in top[:8]))
    return out


def check_outputs(torch, dev, params, ex, requests) -> dict:
    """What comes out is right: the full-width logits of a request are
    finite and shaped [batch]; and on a small model (the ``serve --smoke``
    widths) the card's forward — every kernel — agrees with the plain
    PyTorch forward on the CPU on the same weights and request, with
    identical fault counters.  Tolerance: 1% of the logit scale, in bf16;
    only float summation orders differ (the EmbeddingBag's, the Gram
    product's), and a bf16 step is 2**-8 relative."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm
    from repro_torch.protect import default_plan, protect

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    payload = requests[0].payload
    fwd = protect(functools.partial(dlrm_forward, ex=ex), default_plan())
    logit, _ = fwd(params, torch.from_numpy(payload["dense"]).to(dev),
                   torch.from_numpy(payload["bags"]).to(dev))
    if logit.shape != (payload["dense"].shape[0],) or \
            not bool(torch.isfinite(logit).all()):
        fail(f"full-width logits: shape {tuple(logit.shape)}, finite "
             f"{bool(torch.isfinite(logit).all())}")

    small = dataclasses.replace(ex, table_rows=512, n_tables=4, emb_dim=32,
                                bottom_mlp=(64, 32), top_mlp=(64, 32, 1))
    p_cpu = init_dlrm(0, small, device="cpu")
    rng = np.random.default_rng(13)
    dense = torch.from_numpy(
        rng.standard_normal((10, small.n_dense)).astype(np.float32))
    bags = torch.from_numpy(rng.integers(-1, small.table_rows,
                                         (small.n_tables, 10, 16))
                            .astype(np.int32))
    fwd_s = protect(functools.partial(dlrm_forward, ex=small),
                    default_plan())
    l_cpu, r_cpu = fwd_s(p_cpu, dense, bags)
    l_dev, r_dev = fwd_s(to(p_cpu, dev), dense.to(dev), bags.to(dev))
    m_cpu = metrics_to_ints(r_cpu.as_metrics())
    m_dev = metrics_to_ints(r_dev.as_metrics())
    l_cpu = l_cpu.float()
    err = float((l_dev.float().cpu() - l_cpu).abs().max())
    scale = float(l_cpu.abs().max())
    log(f"outputs: full-width logits finite, shape {tuple(logit.shape)}; "
        f"small model card vs CPU max |dlogit| {err:.3g} of scale "
        f"{scale:.3g}; counters equal {m_cpu == m_dev}")
    if m_cpu != m_dev:
        fail(f"small model counters differ: card {m_dev} vs CPU {m_cpu}")
    if err > 1e-2 * max(scale, 1e-6):
        fail(f"small model logits differ by {err:.3g} (scale {scale:.3g})")
    return {"full_width_logits": [float(v) for v in logit.float().cpu()],
            "small_max_abs_err": err, "small_scale": scale}


def wkv_err(got, want, atol: float, rtol: float = 2e-4):
    """(max |got - want|, worst ratio of |got - want| to the allowed
    ``atol + rtol |want|``; <= 1 passes)."""
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff / (atol + rtol * want.abs())).max()))


#: two runs' inputs to one quantization "agree" within this fraction of
#: the row's largest magnitude (phase 7's logit fraction) or one unit in
#: the last place of the element, whichever is larger
SPLIT_INPUT_TOL = 1e-4


def code_split(torch, cpu_calls, card_calls):
    """The first activation quantization whose int8 codes differ between a
    CPU run and a card run of the same model, or None.  Each list holds
    ``[x, q, alpha, beta]`` per call, in call order.  At the elements whose
    codes differ it reports: the largest code step; whether each side's
    pre-quantization value ``u = (x - beta) / alpha`` (float64) lies on its
    own side of the rounding boundary between the two codes, up to 1e-3 of
    a step (``straddle``); the largest input difference as a share of the
    row's largest magnitude, and whether every input pair agrees within
    :data:`SPLIT_INPUT_TOL` of it or one ulp of the element.  Up to four
    of those elements are listed with each side's x, u and code."""
    if len(cpu_calls) != len(card_calls):
        fail(f"the CPU and the card quantized {len(cpu_calls)} and "
             f"{len(card_calls)} activations in one step")
    for i, (c, d) in enumerate(zip(cpu_calls, card_calls)):
        if torch.equal(c[1], d[1]):
            continue
        (xc, qc, ac, bc), (xd, qd, ad, bd) = c, d
        where = qc != qd
        x64c, x64d = xc.double(), xd.double()
        uc = (x64c - bc.double()[:, None]) / ac.double()[:, None]
        ud = (x64d - bd.double()[:, None]) / ad.double()[:, None]
        edge = torch.minimum(qc, qd).double() + 0.5
        straddle = (torch.minimum(uc, ud) <= edge + 1e-3) & \
            (torch.maximum(uc, ud) >= edge - 1e-3)
        row = torch.maximum(x64c.abs().amax(1), x64d.abs().amax(1))[:, None]
        dx = (x64c - x64d).abs()
        mant = {torch.bfloat16: 7, torch.float16: 10}.get(xc.dtype, 23)
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(x64c.abs(), x64d.abs()).clamp(min=1e-30))) - mant)
        agree = dx <= torch.maximum(SPLIT_INPUT_TOL * row, ulp)
        elems = [{"row": r, "col": col, "x_cpu": float(xc[r, col]),
                  "x_card": float(xd[r, col]), "u_cpu": float(uc[r, col]),
                  "u_card": float(ud[r, col]), "q_cpu": int(qc[r, col]),
                  "q_card": int(qd[r, col])}
                 for r, col in where.nonzero().tolist()[:4]]
        return {"call": i, "shape": list(xc.shape),
                "dtype": str(xc.dtype).replace("torch.", ""),
                "codes_differ": int(where.sum()),
                "max_code_step": int((qc.long() - qd.long()).abs().max()),
                "straddle": bool(straddle[where].all()),
                "inputs_agree": bool(agree[where].all()),
                "max_input_diff_of_row_where_codes_differ": float(
                    (dx / row.clamp(min=1e-30))[where].max()),
                "max_input_diff_of_row": float(
                    (dx / row.clamp(min=1e-30)).max()),
                "alpha_equal": torch.equal(ac, ad),
                "beta_equal": torch.equal(bc, bd), "elements": elems}
    return None


def code_split_is_rounding(split) -> bool:
    """A split of the int8 codes that round-off explains: no code more than
    one step from the other side's, each side's pre-quantization value on
    its own side of the boundary between them, and the inputs in
    agreement wherever the codes differ."""
    return split["max_code_step"] <= 1 and split["straddle"] and \
        split["inputs_agree"]


def wkv_bound(b, s, h, dh, chunk, itemsize=4):
    """Bytes and float operations the chunked WKV6 forward needs: r, k,
    v (``itemsize`` bytes each), lw and u read and y written once, the
    state read and written once; per chunk and head the four products
    (the score tile and its product only below the diagonal), the decay
    of S and the diagonal."""
    n_bytes = (b * s * h * dh * (3 * itemsize + 8)
               + 4 * (h * dh + 2 * b * h * dh * dh))
    tri = chunk * (chunk - 1) // 2
    per_chunk = (2 * chunk * dh * dh * 2 + 2 * tri * dh * 2
                 + 2 * dh * dh + 3 * chunk * dh)
    return n_bytes, b * h * (s // chunk) * per_chunk


def kernel_input_dtypes(run):
    """``run()`` with the K3 and K4 wrappers watched: the types of the x
    (K3) and of the r, k, v (K4) each was handed.  A cast before either
    kernel would show as float32 here.  Returns ``(run's result, {name:
    [dtypes]})``."""
    import repro_torch.kernels.quantize_rows as k3
    import repro_torch.kernels.wkv6_chunked as k4
    real = {"quantize_rows": k3.quantize_rows_cuda,
            "wkv6_chunked": k4.wkv6_chunked_cuda}
    seen = {name: set() for name in real}

    def watch(name, n_args):
        def call(*a, **kw):
            seen[name].add(tuple(str(t.dtype).replace("torch.", "")
                                 for t in a[:n_args]))
            return real[name](*a, **kw)
        # the wrapper counts its launch under its module-level name, which
        # is this function while it watches
        call.launches = 0
        return call

    k3.quantize_rows_cuda = watch("quantize_rows", 1)
    k4.wkv6_chunked_cuda = watch("wkv6_chunked", 3)
    try:
        out = run()
    finally:
        k3.quantize_rows_cuda = real["quantize_rows"]
        k4.wkv6_chunked_cuda = real["wkv6_chunked"]
    return out, {name: sorted(v) for name, v in seen.items()}


def pdl_hazards(torch, dev, gen, cases) -> list:
    """K1 is launched as the programmatic dependent of whatever kernel
    comes before it.  Hold it bit-exact with its plain version (C and
    err_rows) in the four positions where that kernel touches what K1
    reads or writes: right after K3 (which writes A); right after an
    in-place flip of a B' byte and the flip back; right after another K1
    on the same row-sum scratch (as ``recompute`` runs it), alternating
    flagged and clean calls; and right after the ``correct`` policy's
    repair, which must give back the clean C.  ``cases`` are (label, m,
    B') at the path's shapes; each position queues its launches with no
    synchronisation between them, and the comparisons come after."""
    from repro_torch.core import LANE
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call

    def flags(got, a, bp, what):
        for g, w, part in zip(got, ref.abft_qgemm_ref(a, bp),
                              ("C", "err_rows")):
            if not torch.equal(g, w):
                fail(f"K1 under PDL {what}: {part} differs from the plain "
                     f"version")
        return int(got[1].sum())

    def i8(m, k):
        return torch.randint(-128, 128, (m, k), generator=gen,
                             device=dev).to(torch.int8)

    done = []
    for label, m, bp in cases:
        k, n = bp.shape[0], bp.shape[1] - LANE
        row, lane = k // 3, n // 2
        hot, cold = i8(m, k), i8(m, k)
        hot[:, row] = 1                 # a flip in B'[row] shows in every
        cold[:, row] = 0                # row of C, and in none
        b_clean = bp.clone()            # B' as each launch finds it
        b_flip = bp.clone()
        b_flip[row, lane] ^= 0x10
        colsum = torch.sum(b_clean[:, :n].to(torch.int32), dim=0,
                           dtype=torch.int32)
        xs = [torch.randn((m, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(3)]
        torch.cuda.synchronize()
        # 1. K3 -> K1, three times over
        after_k3 = []
        for x in xs:
            q = quantize_rows_cuda(x)[0]
            after_k3.append((q, abft_qgemm_cuda(q, bp)))
        # 2. an in-place flip of a B' byte, K1; the flip back, K1
        bp[row, lane] ^= 0x10
        flipped = abft_qgemm_cuda(hot, bp)
        bp[row, lane] ^= 0x10
        restored = abft_qgemm_cuda(hot, bp)
        # 3. K1 after K1 on the one scratch, flagged and clean in turns
        bp[row, lane] ^= 0x10
        chain = [(a, abft_qgemm_cuda(a, bp)) for a in (hot, cold) * 3]
        # 4. the correct policy repairs C for the flipped B'; K1 at once
        fixed, rep = protected_call("qgemm", (bp, colsum), hot,
                                    rule=ResolvedRule(policy="correct"))
        after_fix = abft_qgemm_cuda(cold, bp)
        bp[row, lane] ^= 0x10
        torch.cuda.synchronize()

        for x, (q, got) in zip(xs, after_k3):
            if not torch.equal(q, ref.quantize_rows_ref(x.float())[0]):
                fail(f"K3 on bf16 differs from the plain version at {label}")
            if flags(got, q, b_clean, f"after K3 at {label}"):
                fail(f"K1 after K3 flagged clean operands at {label}")
        if flags(flipped, hot, b_flip, f"after a flip at {label}") != m or \
                flags(restored, hot, b_clean, f"after the flip back at "
                                              f"{label}"):
            fail(f"K1 right after an in-place flip of B' at {label} did not "
                 f"flag exactly the flipped byte's rows")
        for a, got in chain:
            if flags(got, a, b_flip, f"after K1 at {label}") != \
                    (m if a is hot else 0):
                fail(f"K1 after K1 on one scratch at {label}: wrong flags")
        if flags(after_fix, cold, b_flip, f"after the repair at {label}"):
            fail(f"K1 after the correct repair flagged at {label}")
        if not torch.equal(fixed, ref.abft_qgemm_ref(hot, b_clean)[0]) or \
                int(rep.corrections) != 1:
            fail(f"the correct policy did not repair the flip at {label}")
        if not torch.equal(bp, b_clean):
            fail(f"B' was not restored at {label}")
        del b_clean, b_flip
        done.append(label)
    return done


def eb_checks(torch, enc, bags, label: str) -> dict:
    """K2 against its plain versions on one index set of the stacked tables
    ``enc`` = (table, alphas, betas, C_T): R bit-exact with the slot-order
    sum of the plain terms; rsum within 1e-5 of d x max|R| of the plain
    rsum (another order over d); flags and counts equal to K2's formula
    written plainly (``ref.eb_check_slot_order``) on K2's own rsum at
    rel_bound 1e-3, 1e-5 and 1e-7, and to the plain branch (``verify_bags``)
    at 1e-3 and 1e-5, where no clean bag may be flagged.  At 1e-7 the bound
    is about an ulp of a bag's magnitude, so round-off decides some clean
    bags in any order: how many the plain branch decides otherwise is
    reported, not held."""
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    table, al, be, rs = enc
    d = table.shape[-1]
    want_r = ref.abft_eb_slot_order_ref(table, al, be, bags)
    _, rsum_p = ref.abft_eb_ref(table, al, be, bags)
    scale = max(1.0, float(want_r.abs().max()))
    out = {"rsum_max_abs_err": 0.0}
    for rel in (1e-3, 1e-5, 1e-7):
        r, rsum, flags, count = abft_eb_cuda(table, al, be, bags, rs,
                                             rel_bound=rel)
        if not torch.equal(r, want_r):
            fail(f"abft_embeddingbag: R differs from the slot-order sum at "
                 f"{label} ({int((r != want_r).sum())} elements)")
        e_s = float((rsum - rsum_p).abs().max())
        if e_s > 1e-5 * d * scale:
            fail(f"abft_embeddingbag: rsum off by {e_s:.3g} at {label}")
        out["rsum_max_abs_err"] = max(out["rsum_max_abs_err"], e_s)
        mirror = ref.eb_check_slot_order(rsum, al, be, bags, rs, d,
                                         rel_bound=rel)
        if not torch.equal(flags, mirror) or not torch.equal(
                count, flags.sum(-1, dtype=torch.int32)):
            fail(f"abft_embeddingbag: flags or counts differ from its "
                 f"formula on its own rsum at {label}, rel_bound {rel:g}")
        plain = kops.abft_embedding_bag(table, al, be, bags, rs,
                                        rel_bound=rel, use_kernel=False)
        if rel == 1e-7:
            out["flagged_at_1e-7"] = int(flags.sum())
            out["plain_branch_differs_at_1e-7"] = int(
                (flags != plain.err_bags).sum())
            continue
        if not (torch.equal(flags, plain.err_bags)
                and torch.equal(count, plain.err_count)):
            fail(f"abft_embeddingbag: flags differ from the plain branch at "
                 f"{label}, rel_bound {rel:g}")
        if bool(flags.any()):
            fail(f"abft_embeddingbag flagged clean tables at {label}")
    return out


def eb_flip_sweep(torch, enc, bags) -> list:
    """One bit of a table byte that bag 0 of table 0 reads flipped (C_T
    left stale), each of the 8 positions in turn: the card branch's flags
    and counts equal to the plain branch's at rel_bound 1e-3 and 1e-5.
    Returns the bags flagged per bit at 1e-5."""
    from repro_torch.core import table_rowsums
    from repro_torch.kernels import ops as kops
    table, al, be, rs = enc
    row, col = int(bags[0, 0, 0]), 5
    flagged = []
    for bit in range(8):
        mask = -128 if bit == 7 else 1 << bit
        table[0, row, col] ^= mask
        for rel in (1e-3, 1e-5):
            got, want = (kops.abft_embedding_bag(table, al, be, bags, rs,
                                                 rel_bound=rel, use_kernel=uk)
                         for uk in (True, False))
            if not (torch.equal(got.err_bags, want.err_bags)
                    and torch.equal(got.err_count, want.err_count)):
                fail(f"abft_embeddingbag: flags differ from the plain branch "
                     f"with bit {bit} flipped, rel_bound {rel:g}")
        flagged.append(int(got.err_count.sum()))
        table[0, row, col] ^= mask
    if not flagged[7]:
        fail("abft_embeddingbag missed a flipped high table bit")
    if not torch.equal(table_rowsums(table[0, row]), rs[0, row]):
        fail("the flipped table row was not restored")
    return flagged


def eb_pdl_hazards(torch, enc, bags) -> None:
    """K2 is launched as the programmatic dependent of whatever kernel
    comes before it.  Held with no synchronisation between that kernel and
    K2, in the three positions where it writes what K2 reads or writes:
    right after an in-place flip of a table byte (a torch kernel) and the
    flip back; right after an in-place change of a row's alpha and the
    change back; and right after another K2 whose R and rsum were freed,
    so the allocator hands their memory over, on the same counters, bags
    that read the flipped row and bags that do not in turns."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    table, al, be, rs = enc
    row = int(bags[0, 0, 0])
    cold = torch.where(bags == row, (row + 1) % table.shape[1], bags)
    torch.cuda.synchronize()
    table[0, row, 9] ^= -128
    flipped = abft_eb_cuda(table, al, be, bags, rs)
    table[0, row, 9] ^= -128
    restored = abft_eb_cuda(table, al, be, bags, rs)
    al[0, row] *= 4.0
    scaled = abft_eb_cuda(table, al, be, bags, rs)
    al[0, row] *= 0.25                                # exact: back
    after_alpha = abft_eb_cuda(table, al, be, bags, rs)
    table[0, row, 9] ^= -128
    chain, ptrs = [], set()
    for idx in (bags, cold) * 3:
        r, rsum, flags, count = abft_eb_cuda(table, al, be, idx, rs)
        ptrs.add(r.data_ptr())
        chain.append((idx is bags, flags, count))
        del r, rsum
    last = abft_eb_cuda(table, al, be, bags, rs)
    ptrs.add(last[0].data_ptr())
    torch.cuda.synchronize()
    want_flipped = ref.abft_eb_slot_order_ref(table, al, be, bags)
    table[0, row, 9] ^= -128
    want = ref.abft_eb_slot_order_ref(table, al, be, bags)
    al[0, row] *= 4.0
    want_scaled = ref.abft_eb_slot_order_ref(table, al, be, bags)
    al[0, row] *= 0.25
    for name, got in (("an in-place table flip", flipped),
                      ("K2 on the same allocation", last)):
        if not torch.equal(got[0], want_flipped) or \
                not bool(got[2][0, 0]) or \
                int(got[3].sum()) != int(got[2].sum()):
            fail(f"K2 right after {name}: R or flags wrong")
    for name, got, r_want in (("the flip back", restored, want),
                              ("an alpha change", scaled, want_scaled),
                              ("the alpha change back", after_alpha, want)):
        if not torch.equal(got[0], r_want) or bool(got[2].any()) or \
                int(got[3].sum()):
            fail(f"K2 right after {name}: R or flags wrong")
    for hot, flags, count in chain:
        if bool(flags[0, 0]) != hot or bool(flags.any()) != hot or \
                not torch.equal(count, flags.sum(-1, dtype=torch.int32)):
            fail("K2 right after K2 on the same counters: wrong flags")
    if len(ptrs) > 2:
        fail("the allocator did not hand K2's freed R over")


def eb_bounds(bags, d: int):
    """K2's least time, ``(useful, sectors)``, each ``(ms, by)``.  Useful
    bytes: each valid slot's d-byte row and its alpha, beta and C_T, the
    indices read once, R, rsum, the flags and the counts written once;
    sectors: the same with each random alpha, beta and C_T load a 32-byte
    sector.  Operations: 4 a row element, ~10 a slot for the check, and
    rsum's adds."""
    from repro_torch.benchmarks.common import F32_OPS_PER_S, bound_ms
    valid = int((bags >= 0).sum())
    t, b, p = bags.shape
    rest = 4 * t * b * p + t * b * (4 * d + 5) + 4 * t
    ops = valid * (4 * d + 10) + t * b * d
    return (bound_ms(valid * (d + 12) + rest, ops, F32_OPS_PER_S),
            bound_ms(valid * (d + 3 * 32) + rest, ops, F32_OPS_PER_S))


def device_ops(torch, fn) -> list:
    """The device operations (kernels, copies, fills) one call of ``fn``
    runs, by the profiler, after a warm-up call: ``[(name, count)]``.
    Fails if the profiler traces nothing on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(ev.key, ev.count) for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    if not ops:
        fail("the profiler traced no device operation")
    return ops


def pair_times(timer, calls, reps: int, rounds: int = 3) -> dict:
    """K3 -> K1 against K1 alone over the same calls.  ``calls`` holds
    (x, q, next_b) per qlinear: x the bf16 activation, q its int8 rows
    (K3's output, made beforehand) and next_b the weight each K1 call
    takes (cycling cold slices where there are several).  The pair runs
    K1 on K3's fresh output, as the path does; its excess over K1 alone
    is what K3 adds (``exposed_ms``), the time programmatic dependent
    launch should hide.  The same two with both kernels launched as plain
    stream successors (``*_no_pdl_ms``) show what it buys.  Medians over
    ``rounds`` rounds, in turns."""
    import numpy as np

    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda

    def alone(pdl):
        for _, q, next_b in calls:
            abft_qgemm_cuda(q, next_b(), pdl=pdl)

    def pair(pdl):
        for x, _, next_b in calls:
            abft_qgemm_cuda(quantize_rows_cuda(x, pdl=pdl)[0], next_b(),
                            pdl=pdl)

    def k3():
        for x, _, _ in calls:
            quantize_rows_cuda(x)

    order = [("k1_alone_ms", lambda: alone(True)),
             ("pair_ms", lambda: pair(True)),
             ("pair_no_pdl_ms", lambda: pair(False)),
             ("k1_alone_no_pdl_ms", lambda: alone(False)),
             ("k3_ms", k3)]
    runs = {key: [] for key, _ in order}
    for r in range(rounds):
        for key, fn in (order if r % 2 == 0 else order[::-1]):
            runs[key].append(timer.ms(fn, reps))
    out = {k: float(np.median(v)) for k, v in runs.items()}
    out["exposed_ms"] = out["pair_ms"] - out["k1_alone_ms"]
    out["exposed_no_pdl_ms"] = out["pair_no_pdl_ms"] - \
        out["k1_alone_no_pdl_ms"]
    out["runs"] = runs
    return out


def rwkv_phases(torch, dev, timer, details, cfg, big_batch_seq) -> dict:
    """Phases 6-8 on RWKV6 config ``cfg`` (the full-width RWKV6-1.6B from
    :func:`main`), with K4 also held and timed at ``big_batch_seq`` =
    (B, S).  Returns the K4 row and the RWKV path's launch counts."""
    import numpy as np

    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.configs import reduce_cfg
    from repro_torch.core import LANE
    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import BK as K1_BK, \
        abft_qgemm_cuda, launch_plan
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda, wkv_plan
    from repro_torch.layers import rwkv6 as rk
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.protect import default_plan
    from repro_torch.serving import (Request, ServingEngine, TenantSpec,
                                     chat_stream)

    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, [TenantSpec("default", default_plan())],
                           n_slots=4, max_prompt=64, seed=0, device=dev)
    torch.cuda.synchronize()
    params = engine.params
    n_int8 = sum(t.numel() for t in (
        [params["embed"]["table"], params["head"]["w_packed"]]
        + [params["layers"][blk][w]["w_packed"] for blk, ws in
           (("tm", ("wr", "wk", "wv", "wg", "wo")), ("cm", ("wk", "wv")))
           for w in ws]))
    log(f"{cfg.name} (d {cfg.d_model}, {cfg.n_layers} layers) on the card in "
        f"{time.perf_counter() - t0:.1f}s: {n_int8 / 1e9:.2f} GB of int8 "
        f"(packed) weights and table")

    def stream(n, seed):
        return chat_stream(n, tenants={"default": 1.0}, rate_rps=100.0,
                           seed=seed, mean_prompt=32, max_prompt=64,
                           mean_output=16, max_output=32)

    # ------------------- 6. kernels at the RWKV path's shapes ---------------
    gen = torch.Generator(device=dev).manual_seed(2)
    layers = params["layers"]
    # each GEMM shape with its weights of every layer, [layers, k, n + 128]
    gemms = [("tm.wr", layers["tm"]["wr"]["w_packed"], (64, 4)),
             ("cm.wk", layers["cm"]["wk"]["w_packed"], (64, 4)),
             ("cm.wv", layers["cm"]["wv"]["w_packed"], (64, 4)),
             ("lm_head", params["head"]["w_packed"][None], (1, 4))]
    checked = []
    for name, stack, ms_ in gemms:
        bp = stack[0]
        k, n = bp.shape[0], bp.shape[1] - LANE
        checked.append(f"{name} (k, n) = ({k}, {n}) at m = {ms_}")
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = quantize_rows_cuda(x)
            for g, w, g32, what in zip(q, ref.quantize_rows_ref(x),
                                       quantize_rows_cuda(x.float()),
                                       ("q", "alpha", "beta")):
                if not (torch.equal(g, w) and torch.equal(g32, w)):
                    fail(f"quantize_rows: {what} differs at {m}x{k} (bf16 "
                         f"or its f32 cast)")
            for col in (False, True):
                got = abft_qgemm_cuda(q[0], bp, with_colcheck=col)
                want = ref.abft_qgemm_ref(q[0], bp, with_colcheck=col)
                for g, w, what in zip(got, want,
                                      ("C", "err_rows", "col_check")):
                    if not torch.equal(g, w):
                        fail(f"abft_qgemm: {what} differs at {name} m={m} "
                             f"(k={k}, n={n})")
                if int(got[1].sum()):
                    fail(f"abft_qgemm flagged clean operands at {name}")
    log("K1 (C, err_rows, column check) and K3 (bf16 and f32) bit-exact "
        "at " + "; ".join(checked))
    hazards = pdl_hazards(torch, dev, gen, [
        (f"{name} (k, n) = ({st.shape[1]}, {st.shape[2] - LANE}) m = {ms_[0]}",
         ms_[0], st[0]) for name, st, ms_ in gemms] + [
        ("cm.wv m = 4", 4, layers["cm"]["wv"]["w_packed"][1])])
    log("K1 under PDL bit-exact after K3, after an in-place flip of B', "
        "after K1 on the same scratch and after the correct repair at "
        + "; ".join(hazards))

    emb = params["embed"]
    enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
            emb["rowsums"][None])
    req0 = stream(1, 5)[0]
    prompt = torch.from_numpy(
        engine._chat_tokens(req0, 64).astype(np.int32)).to(dev)
    k2 = {"checks": {}, "times": {}}
    for n_bags in (64, 4):
        idx = prompt[:n_bags].reshape(1, -1, 1)
        label = f"{n_bags} tokens"
        k2["checks"][label] = eb_checks(torch, enc4, idx, label)
        # cold rows: each launch looks up fresh random tokens
        sets = [torch.randint(0, cfg.vocab, idx.shape, generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(16)]
        it = itertools.cycle(sets)
        (b_ms, _), (s_ms, _) = eb_bounds(idx, cfg.d_model)
        k2["times"][label] = {
            "ms": timer.ms(lambda: abft_eb_cuda(*enc4[:3], next(it),
                                                enc4[3]), 32),
            "plain_ms": timer.ms(lambda: kops.abft_embedding_bag(
                *enc4[:3], next(it), enc4[3], use_kernel=False), 8),
            "bound_ms": b_ms, "sector_bound_ms": s_ms}
    eb_pdl_hazards(torch, enc4, prompt.reshape(1, -1, 1))
    log(f"K2 on the {tuple(emb['table'].shape)} token table at pool 1 (64 "
        f"and 4 bags): R bit-exact with the slot-order sum, flags equal to "
        f"the plain branch at rel_bound 1e-3 and 1e-5 and to its formula at "
        f"all three, under PDL after a table flip, an alpha change and "
        f"another K2; ms (cold) / plain / bound / sector bound: "
        + "; ".join(f"{k}: {v['ms']:.5f} / {v['plain_ms']:.4f} / "
                    f"{v['bound_ms']:.6f} / {v['sector_bound_ms']:.6f}"
                    for k, v in k2["times"].items()))

    # K4 on the prefill's own inputs: capture every layer's WKV call
    captured = []
    real_wkv = kops.wkv_chunked

    def capture(*a, **kw):
        captured.append(([t.clone() for t in a], kw["chunk"]))
        return real_wkv(*a, **kw)

    kops.wkv_chunked = capture
    try:
        engine.lanes[0].prefill_fn(params, engine._chat_batch(req0))
    finally:
        kops.wkv_chunked = real_wkv
    if len(captured) != cfg.n_layers:
        fail(f"prefill ran {len(captured)} chunked WKV calls, not "
             f"{cfg.n_layers}")
    shape = tuple(captured[0][0][0].shape)
    if shape != (1, 64, h, dh) or captured[0][1] != 16:
        fail(f"unexpected prefill WKV shape {shape}, chunk "
             f"{captured[0][1]}")

    if captured[0][0][0].dtype != torch.bfloat16:
        fail(f"the prefill handed K4 {captured[0][0][0].dtype} r, k, v, not "
             f"its bf16 projections")
    k4 = {"model_max_abs_err": 0.0, "model_worst_ratio": 0.0,
          "model vs plain": {"y": 0.0, "S": 0.0}}
    for args, chunk in captured:
        y_k, s_k = wkv6_chunked_cuda(*args, chunk=chunk)
        f32 = [t.float() for t in args[:3]] + list(args[3:])
        for name, (y_w, s_w) in (
                ("plain", ref.wkv_chunked_ref(*args, chunk=chunk)),
                ("recurrence", rk.wkv_recurrent(*f32))):
            # the model's r, k, v reach some tens: 2e-4 of each output's
            # scale as the absolute part
            for part, got, want in (("y", y_k, y_w), ("S", s_k, s_w)):
                err, ratio = wkv_err(got, want,
                                     2e-4 * float(want.abs().max()))
                if not bool(torch.isfinite(got).all()) or ratio > 1.0:
                    fail(f"wkv6_chunked off the {name} version on model "
                         f"inputs: max |d| {err:.3g}, {ratio:.3g}x the "
                         f"2e-4 bound")
                if name == "plain":
                    k4["model_max_abs_err"] = max(k4["model_max_abs_err"],
                                                  err)
                    k4["model vs plain"][part] = max(
                        k4["model vs plain"][part], err)
                k4["model_worst_ratio"] = max(k4["model_worst_ratio"],
                                              ratio)
    k4["model_y_scale"] = max(float(ref.wkv_chunked_ref(*a, chunk=c)[0]
                                    .abs().max()) for a, c in captured)

    def wkv_random(b, s, dh_, decay):
        r, k, v = (torch.randn((b, s, h, dh_), generator=gen, device=dev)
                   for _ in range(3))
        if decay == "heavy":
            lw = torch.rand((b, s, h, dh_), generator=gen, device=dev) \
                * rk.LOG_W_MIN
        else:               # all LOG_W_MIN on unit inputs: kin at e^(5 C)
            r, k, v = (torch.ones_like(r) for _ in range(3))
            lw = torch.full_like(r, rk.LOG_W_MIN)
        u = torch.randn((h, dh_), generator=gen, device=dev) * 0.5
        s0 = torch.randn((b, h, dh_, dh_), generator=gen, device=dev) * 0.1
        return [r, k, v, lw, u, s0]

    # K4 at batch 1 and 2, dh 64 and 32, chunk 16 and 8, heavy and all-min
    # decay, r/k/v in bf16 and f32, staged by 16- and by 4-byte copies; and
    # at big_batch_seq against the plain version only (the recurrence is a
    # Python loop over its tokens)
    cases = [(f"B{b_} dh{dh_} chunk{ch_} {decay}",
              wkv_random(b_, 64, dh_, decay), ch_, True)
             for b_, dh_, ch_, decay in itertools.product(
                 (1, 2), (64, 32), (16, 8), ("heavy", "all_min"))]
    big = wkv_random(*big_batch_seq, dh, "heavy")
    big_label = str(tuple(big[0].shape))
    cases.append((big_label, big, 16, False))
    worst_ratio = {}
    for label, args, ch_, with_rec in cases:
        b_, s_, _, dh_ = args[0].shape
        for dtype in (torch.bfloat16, torch.float32):
            rkv = [t.to(dtype) for t in args[:3]]
            refs = [("plain", ref.wkv_chunked_ref(*rkv, *args[3:],
                                                  chunk=ch_))]
            if with_rec:
                refs.append(("recurrence", rk.wkv_recurrent(
                    *(t.float() for t in rkv), *args[3:])))
            for vec in (16, 4):
                plan = wkv_plan(b_, h, dh_, ch_, seq=s_,
                                itemsize=rkv[0].element_size())
                y_k, s_k = wkv6_chunked_cuda(*rkv, *args[3:], chunk=ch_,
                                             plan=plan._replace(vec=vec))
                way = f"{vec}-byte copies"
                for name, (y_w, s_w) in refs:
                    errs = {}
                    for part, got, want in (("y", y_k, y_w),
                                            ("S", s_k, s_w)):
                        errs[part], ratio = wkv_err(got, want, 2e-4)
                        if not bool(torch.isfinite(got).all()) or \
                                ratio > 1.0:
                            fail(f"wkv6_chunked ({way}, {dtype}) off the "
                                 f"{name} version ({label}): max "
                                 f"|d{part}| {errs[part]:.3g}, "
                                 f"{ratio:.3g}x the bound")
                        worst_ratio[name] = max(
                            worst_ratio.get(name, 0.0), ratio)
                    k4[f"{label} {str(dtype)[6:]} {way} vs {name}"] = errs
    log(f"K4 within 2e-4 of the plain version and of the recurrence on "
        f"all {len(captured)} layers' bf16 prefill inputs (max |dy| "
        f"{k4['model_max_abs_err']:.3g} of a scale "
        f"{k4['model_y_scale']:.3g}); on {len(cases) - 1} cases (batch 1 "
        f"and 2, dh 64 and 32, chunk 16 and 8, heavy and all-min decay) "
        f"and at {big_label} (plain only), each in bf16 and f32, staged by "
        f"16- and 4-byte copies: worst error {worst_ratio} of the bound")

    # -------------------------- 7. serve + flips ----------------------------
    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))            # the warm-up runs inside
    launches = read_launches(wrappers)
    s = tel.summary()
    per = s["per_tenant"]["default"]
    counters = s["faults"]["counters"]
    n_pre = sum(ev.kind == "prefill" for ev in tel.steps)
    n_dec = sum(ev.kind == "decode" for ev in tel.steps)
    log(f"served {per['requests']} chat requests: {per['completed']} "
        f"completed in {n_pre} prefills and {n_dec} decode steps; "
        f"launches {launches}; counters "
        f"{ {k: v for k, v in counters.items() if v} }")
    if per["completed"] != 8 or per["aborted"]:
        fail(f"not every chat request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean RWKV run: {nonzero}")
    steps = n_pre + n_dec
    per_step_gemms = cfg.n_layers * 7 + 1
    if counters["qgemm_checks"] != per_step_gemms * steps or \
            counters["embedding_bag_checks"] != steps:
        fail(f"unexpected check counts {counters} for {steps} steps")
    # the warm-up ran one prefill and one decode step inside the window
    want_l = {"wkv6_chunked": cfg.n_layers * (n_pre + 1),
              "abft_qgemm": per_step_gemms * (steps + 2),
              "quantize_rows": per_step_gemms * (steps + 2),
              "abft_embeddingbag": steps + 2,
              "qgemm_unprotected": 0, "eb_unprotected": 0}
    if launches != want_l:
        fail(f"launches {launches} differ from the path's {want_l}")
    toks = [t for r in tel.requests for t in (r.tokens or [])]
    if len(toks) != per["tokens_out"] or \
            not all(0 <= t < cfg.vocab for t in toks):
        fail("served tokens outside the vocabulary or missing")
    pre_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps
                    if ev.kind == "prefill")
    dec_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps
                    if ev.kind == "decode")
    serve = {"requests": per["requests"], "prefills": n_pre,
             "decode_steps": n_dec, "tokens_out": per["tokens_out"],
             "prefill_ms": pre_ms, "decode_ms": dec_ms,
             "prefill_ms_median": float(np.median(pre_ms)),
             "decode_ms_median": float(np.median(dec_ms)),
             "ttft_ms": per["ttft_ms"], "per_token_ms": per["per_token_ms"],
             "decode_occupancy_mean": s["decode_occupancy_mean"],
             "launches": launches, "counters": counters}

    def one_request(seed):
        req = Request(rid=0, tenant="default", arrival_s=0.0,
                      prompt_len=64, max_new_tokens=2, seed=seed)
        return req, engine.run([req], warmup=False).summary()[
            "faults"]["counters"]

    # faults through FaultInjection, each at the step of one request's
    # prefill (and its decode): a cm.wv payload bit, and a high bit of the
    # embedding row of one of the prompt's tokens
    from repro_torch.serving import FaultInjection

    def inject_run(req, inj, leaf):
        engine.reset_state()
        before = leaf_fingerprint(torch, leaf)
        tel = engine.run([req], inject=[inj], warmup=False)
        return tel, before, leaf_fingerprint(torch, leaf)

    def request(seed):
        return Request(rid=0, tenant="default", arrival_s=0.0,
                       prompt_len=64, max_new_tokens=2, seed=seed)

    tel, fp0, fp1 = inject_run(request(11), FaultInjection(
        step=0, victim="cm.wv", seed=0), layers["cm"]["wv"]["w_packed"])
    r_flips = {"weight": check_injection(tel, 0, [0], fp0, fp1,
                                         "RWKV cm.wv flip")}
    req = request(12)
    prompt_rows = set(engine._chat_tokens(req, 64).tolist())
    e_seed = injection_seed(
        torch, emb["table"], "embed.table",
        lambda idx: idx // emb["table"].shape[1] in prompt_rows)
    tel, fp0, fp1 = inject_run(req, FaultInjection(
        step=0, victim="embed", seed=e_seed), emb["table"])
    r_flips["table"] = check_injection(tel, 0, [0], fp0, fp1,
                                       "RWKV embedding flip")
    r_flips["table"]["seed"] = e_seed
    engine.reset_state()
    _, c_clean = one_request(12)
    if c_clean["qgemm_errors"] or c_clean["embedding_bag_errors"]:
        fail("errors after restoring the injected RWKV flips")
    r_flips["restored"] = c_clean
    log(f"FaultInjection on RWKV: {r_flips['weight']['victim']} and "
        f"{r_flips['table']['victim']} (seed {e_seed}, a prompt token's "
        f"row) each flagged at its step 0 only; both leaves bit-identical "
        f"afterwards; a clean request after: no errors")
    details["rwkv_flips"] = r_flips

    # the smoke-size model: card against the plain CPU run
    small = reduce_cfg(cfg)
    model = build_model(small)
    p_cpu = model.init(0, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return tree.to(device)

    p_dev = to(p_cpu, dev)
    # the same port code on both sides; the card sums the WKV and the
    # EmbeddingBag in another order.  A 24-token prompt is off the 16-token
    # WKV chunk grid: K4 runs its first 16 tokens and the per-token
    # recurrence the other 8.  Every activation quantization (K3 on the
    # card, its plain version on the CPU) is watched, and where the two
    # runs' int8 codes first differ the split must be a rounding one
    # (code_split_is_rounding); it is printed with its element and
    # pre-quantization values.  Each case runs twice:
    # * free: the logits are held to 1e-4 of their scale at every step
    #   before that split, and from it an f32 run stays at 1e-4 and a bf16
    #   run is held to 2**-4, the bf16 allowance the CPU tests hold the
    #   port to against the JAX package (tests/test_torch_rwkv.py);
    # * lockstep: the card runs each step first, and the CPU run takes the
    #   card's codes (q, alpha, beta) at every quantization where the two
    #   split by a rounding, and fails at any other split.  Given the same
    #   codes, every step's logits are held to 1e-4.
    # Both hold the counters equal, and the greedy tokens wherever the
    # CPU's top-two margin leaves room for the bound
    after_split = {torch.float32: 1e-4, torch.bfloat16: 2.0**-4}
    watch = {"side": "card", "lockstep": False, "step": 0, "at": 0,
             "card": [], "cpu": [], "taken": []}
    real_quant = kops.quantize_rows

    def quantize(x, **kw):
        out = real_quant(x, **kw)
        got = [t.detach().to("cpu", copy=True) for t in (x, *out)]
        watch[watch["side"]].append(got)
        if watch["side"] == "card" or not watch["lockstep"]:
            return out
        i = len(watch["cpu"]) - 1
        if i >= len(watch["card"]):
            fail("the CPU run quantized more activations than the card's")
        card = watch["card"][i]
        if torch.equal(out[0], card[1]):
            return out
        split = code_split(torch, [got], [card])
        split.update(step=watch["step"], call=i)
        if not code_split_is_rounding(split):
            fail(f"smoke RWKV in lockstep: the int8 codes part by more "
                 f"than a rounding: {split}")
        watch["taken"].append(split)
        return tuple(t.to(x.device) for t in card[1:])

    def both(step, on_card, on_cpu):
        watch.update(step=step)
        watch["card"].clear()
        watch["cpu"].clear()
        watch["side"] = "card"
        dev_out = on_card()
        watch["side"] = "cpu"
        cpu_out = on_cpu()
        if len(watch["cpu"]) != len(watch["card"]):
            fail(f"the CPU and the card quantized {len(watch['cpu'])} and "
                 f"{len(watch['card'])} activations at step {step}")
        return cpu_out, dev_out

    def run_case(tokens, ctx, lockstep):
        watch.update(lockstep=lockstep, taken=[])
        label = f"{ctx.compute_dtype}, prompt {tokens.shape[1]}, " + (
            "lockstep" if lockstep else "free")
        (lc, cc, rc), (ld, cd, rd) = both(
            0, lambda: model.prefill(p_dev, {"tokens": tokens.to(dev)}, ctx),
            lambda: model.prefill(p_cpu, {"tokens": tokens}, ctx))
        split, errs = None, []
        for step in range(4):
            if split is None and not lockstep:
                split = code_split(torch, watch["cpu"], watch["card"])
                if split is not None:
                    split["step"] = step
                    if not code_split_is_rounding(split):
                        fail(f"smoke RWKV ({label}): the int8 codes part at "
                             f"step {step} by more than a rounding: {split}")
            mc = metrics_to_ints(rc.as_metrics())
            md = metrics_to_ints(rd.as_metrics())
            if mc != md:
                fail(f"smoke RWKV counters differ at step {step} ({label}): "
                     f"card {md} vs CPU {mc}")
            lcf, ldf = lc.float(), ld.float().cpu()
            scale = max(float(lcf.abs().max()), 1e-6)
            err = float((ldf - lcf).abs().max()) / scale
            lcf, ldf = lcf[:, :small.vocab], ldf[:, :small.vocab]
            bound = 1e-4 if split is None else after_split[ctx.compute_dtype]
            errs.append(err)
            if err > bound or not bool(torch.isfinite(ld).all()):
                fail(f"smoke RWKV logits ({label}) differ by {err:.3g} of "
                     f"the scale at step {step} (bound {bound:g}; first code "
                     f"split {split})")
            # two logits each within bound * scale move their gap by at
            # most twice that
            top2 = torch.topk(lcf, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * bound * scale
            if not torch.equal(ldf.argmax(-1)[clear], lcf.argmax(-1)[clear]):
                fail(f"smoke RWKV ({label}): the card's greedy token differs "
                     f"at step {step}")
            if step == 3:
                break
            nxt = torch.argmax(lcf, -1).to(torch.int32)
            (lc, cc, rc), (ld, cd, rd) = both(
                step + 1,
                lambda: model.decode(p_dev, cd, nxt.to(dev), None, ctx),
                lambda: model.decode(p_cpu, cc, nxt, None, ctx))
        if lockstep:
            return {"err_of_scale_by_step": errs,
                    "codes_taken_from_the_card": len(watch["taken"]),
                    "first_taken": (watch["taken"] or [None])[0]}
        return {"err_of_scale_by_step": errs, "first_code_split": split}

    small_out = {}
    kops.quantize_rows = quantize
    try:
        for seq in (64, 24):
            tokens = torch.from_numpy(np.random.default_rng(13).integers(
                0, small.vocab, (2, seq)).astype(np.int32))
            for dtype in (torch.float32, torch.bfloat16):
                ctx = Ctx(quant=True, plan=default_plan(),
                          compute_dtype=dtype, wkv_chunk=small.wkv_chunk)
                for lockstep in (False, True):
                    small_out[f"prompt {seq} {str(dtype)[6:]} "
                              + ("lockstep" if lockstep else "free")] = \
                        run_case(tokens, ctx, lockstep)
    finally:
        kops.quantize_rows = real_quant
    log("smoke RWKV prefill + 3 decodes, card vs CPU: counters equal; "
        "|dlogit| / scale by step, and the first int8 code split (free) or "
        "the codes the CPU took from the card at rounding splits "
        "(lockstep): " + "; ".join(
            f"{k}: {[f'{e:.3g}' for e in v['err_of_scale_by_step']]}, "
            + (f"split {v['first_code_split']}" if "first_code_split" in v
               else f"{v['codes_taken_from_the_card']} taken, the first "
                    f"{v['first_taken']}")
            for k, v in small_out.items()))

    # the smoke-size engines at a 24-token bucket, on the card and on the
    # CPU with the same weights and requests: every request served, the
    # same fault counters, K4 launched for the prefills' whole chunk
    def small_engine(device):
        return ServingEngine(small, [TenantSpec("default", default_plan())],
                             n_slots=4, max_prompt=24, seed=0, device=device)

    def bucket_requests():
        return [Request(rid=i, tenant="default", arrival_s=0.0,
                        prompt_len=24, max_new_tokens=4, seed=60 + i)
                for i in range(4)]

    eng_cpu, eng_dev = small_engine("cpu"), small_engine(dev)
    eng_dev.params = to(eng_cpu.params, dev)
    eng_dev.warmup()
    wkv6_chunked_cuda.launches = 0
    bucket = {}
    for where, eng in (("cpu", eng_cpu), ("card", eng_dev)):
        tel_b = eng.run(bucket_requests())
        per_b = tel_b.summary()["per_tenant"]["default"]
        bucket[where] = {"completed": per_b["completed"],
                         "counters": tel_b.summary()["faults"]["counters"]}
    bucket["k4_launches"] = wkv6_chunked_cuda.launches
    if bucket["cpu"] != bucket["card"] or bucket["card"]["completed"] != 4 \
            or bucket["k4_launches"] != 4 * small.n_layers:
        fail(f"the 24-token bucket served differently on the card: {bucket}")
    log(f"smoke RWKV engine at a 24-token bucket: 4 requests on the card "
        f"and on the CPU, counters equal "
        f"{ {k: v for k, v in bucket['card']['counters'].items() if v} }, "
        f"K4 {bucket['k4_launches']} launches (one per layer a prefill)")

    # ------------------------------ 8. times --------------------------------
    m_args = captured[0][0]             # bf16 r, k, v, as the path hands
    nb, nops = wkv_bound(1, 64, h, dh, 16, itemsize=2)
    b_ms, b_by = bound_ms(nb, nops, F32_OPS_PER_S)
    nb_big, nops_big = wkv_bound(*big_batch_seq, h, dh, 16)
    # on the path's bf16 and on the f32 cast
    f32_args = [t.float() for t in m_args[:3]] + list(m_args[3:])
    k4_plans = {}
    for dname, a_ in (("bfloat16", m_args), ("float32", f32_args)):
        plan = wkv_plan(1, h, dh, 16, seq=64, itemsize=a_[0].element_size())
        k4_plans[dname] = {
            "plan": plan._asdict(), "blocks": plan.blocks,
            "ms": timer.ms(lambda: wkv6_chunked_cuda(*a_, chunk=16))}
    k4_row = {
        "name": "wkv6_chunked", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6_chunked.cu",
        "replaces": REPLACES["wkv6_chunked"],
        "launches": launches["wkv6_chunked"],
        "max_abs_err": k4["model_max_abs_err"],
        "ms": timer.ms(lambda: wkv6_chunked_cuda(*m_args, chunk=16)),
        "plain_ms": timer.ms(lambda: ref.wkv_chunked_ref(*m_args,
                                                         chunk=16)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "per": f"one prefill: {cfg.n_layers} launches (one per layer) at "
               f"{shape}, chunk 16, r/k/v bf16",
        "plan": wkv_plan(1, h, dh, 16, seq=64, itemsize=2)._asdict(),
        "by_dtype": k4_plans}
    big_bound = bound_ms(nb_big, nops_big, F32_OPS_PER_S)
    k4_big = {"ms": timer.ms(lambda: wkv6_chunked_cuda(*big, chunk=16), 5),
              "plain_ms": timer.ms(lambda: ref.wkv_chunked_ref(*big,
                                                               chunk=16), 3),
              "bound_ms": big_bound[0], "bound_by": big_bound[1]}
    log(f"K4 at {shape}: {k4_row['ms']:.4f} ms with plan {k4_row['plan']} "
        f"(bound {b_ms:.5f} ms by {b_by}, plain {k4_row['plain_ms']:.4f} "
        f"ms); by r/k/v type: "
        + "; ".join(f"{k_} ({v['blocks']} blocks) {v['ms']:.4f}"
                    for k_, v in k4_plans.items()) + "; at "
        f"{big_label}: {k4_big['ms']:.3f} ms (bound "
        f"{big_bound[0]:.4f} ms, plain {k4_big['plain_ms']:.3f} ms)")
    # K1 and K3 at every GEMM shape of an RWKV step (prefill m = 64,
    # decode m = 4; the head sees m = 1 in a prefill): where a step's
    # device time goes.  K1 as the path finds its weights, cold: each call
    # takes the next layer's slice (24 slices of each shape hold 100-350
    # MB, above the 50 MB L2; the head's 134 MB is cold by size), and warm
    # (one slice again and again).  The yardstick is torch._int_mm on the
    # same cold slices, padded to n + 1 -> a multiple of 8 columns and to
    # m = 32 rows where m <= 16 (its shape limits).
    per_shape = {}
    for name, stack, ms_ in gemms:
        k, n = stack.shape[1], stack.shape[2] - LANE
        n8 = -(-(n + 1) // 8) * 8
        padded = [w[:, :n8].contiguous() for w in stack]
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=dev)
            q = quantize_rows_cuda(x)[0]
            a_pad = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device=dev)
            a_pad[:m] = q
            cold = itertools.cycle(list(stack))
            cold_pad = itertools.cycle(padded)
            reps = 2 * len(stack) if len(stack) > 1 else 10
            kb = m * k + k * (n + 1) + 4 * m * n + 4 * m
            b_ms = bound_ms(kb, 2 * m * k * (n + 1), INT8_OPS_PER_S)[0]
            plan = launch_plan(m, k, n, a_addr=q.data_ptr(),
                               b_addr=stack[0].data_ptr())
            x16 = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            cold_pair = itertools.cycle(list(stack))
            row = {
                "pair": pair_times(timer, [(x16, quantize_rows_cuda(x16)[0],
                                            lambda: next(cold_pair))], reps),
                "abft_qgemm_cold_ms": timer.ms(
                    lambda: abft_qgemm_cuda(q, next(cold)), reps),
                "abft_qgemm_warm_ms": timer.ms(
                    lambda: abft_qgemm_cuda(q, stack[0])),
                "library_cold_ms": timer.ms(
                    lambda: torch._int_mm(a_pad, next(cold_pad)), reps),
                "abft_qgemm_bound_ms": b_ms,
                "plan": {"bm": plan.bm, "splits": plan.splits,
                         "blocks": plan.blocks, "aligned": plan.aligned},
                "quantize_rows_ms": timer.ms(lambda: quantize_rows_cuda(x)),
                "quantize_rows_bf16_ms": timer.ms(
                    lambda: quantize_rows_cuda(x16))}
            row["bound_share"] = b_ms / row["abft_qgemm_cold_ms"]
            per_shape[f"{name} m={m} k={k} n={n}"] = row
        del padded
    # the evidence for the plan's split rule: K1 cold at each layer shape
    # under every cluster size that splits k evenly enough (each result
    # also held against the plain version), beside the plan's choice
    sweep = {}
    for name, stack, ms_ in gemms[:3]:
        k, n = stack.shape[1], stack.shape[2] - LANE
        for m in ms_:
            q = quantize_rows_cuda(torch.randn((m, k), generator=gen,
                                               device=dev))[0]
            base = launch_plan(m, k, n, a_addr=q.data_ptr(),
                               b_addr=stack[0].data_ptr())
            want = ref.abft_qgemm_ref(q, stack[0])
            ksteps = -(-k // K1_BK)
            by_splits = {}
            for s_ in range(1, 9):
                per_ = -(-ksteps // s_)
                if -(-ksteps // per_) != s_:
                    continue
                p_ = base._replace(splits=s_, k_per_split=per_ * K1_BK)
                got = abft_qgemm_cuda(q, stack[0], plan=p_)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"abft_qgemm with {s_} splits differs at {name} "
                         f"m={m}")
                cold = itertools.cycle(list(stack))
                by_splits[s_] = timer.ms(
                    lambda: abft_qgemm_cuda(q, next(cold), plan=p_),
                    2 * len(stack))
            sweep[f"{name} m={m}"] = {"plan_splits": base.splits,
                                      "blocks_per_split": base.tiles_n,
                                      "ms_by_splits": by_splits}
    log("K1 split sweep, cold ms by cluster size (the plan's in brackets): "
        + "; ".join(f"{k_} [{v['plan_splits']}]: " + ", ".join(
            f"{s_}: {t:.4f}" for s_, t in v["ms_by_splits"].items())
            for k_, v in sweep.items()))
    log("K1 per RWKV shape, ms cold / warm / torch._int_mm cold / bound "
        "(share); K3 ms f32 / bf16; K3 -> K1 pair ms, K1 alone, exposed: "
        + "; ".join(
            f"{k_}: {v['abft_qgemm_cold_ms']:.4f} / "
            f"{v['abft_qgemm_warm_ms']:.4f} / {v['library_cold_ms']:.4f} / "
            f"{v['abft_qgemm_bound_ms']:.5f} ({v['bound_share']:.2f}); "
            f"{v['quantize_rows_ms']:.4f} / "
            f"{v['quantize_rows_bf16_ms']:.4f}; {v['pair']['pair_ms']:.4f}, "
            f"{v['pair']['k1_alone_ms']:.4f}, "
            f"{v['pair']['exposed_ms']:.4f} (no PDL "
            f"{v['pair']['pair_no_pdl_ms']:.4f}, "
            f"{v['pair']['k1_alone_no_pdl_ms']:.4f}, "
            f"{v['pair']['exposed_no_pdl_ms']:.4f})"
            for k_, v in per_shape.items()))
    prof_reqs = [Request(rid=i, tenant="default", arrival_s=0.0,
                         prompt_len=64, max_new_tokens=4, seed=40 + i)
                 for i in range(4)]
    serve["profile"], dtypes = kernel_input_dtypes(
        lambda: profile_requests(torch, engine, prof_reqs))
    serve["kernel_input_dtypes"] = dtypes
    if dtypes != {"quantize_rows": [("bfloat16",)],
                  "wkv6_chunked": [("bfloat16",) * 3]}:
        fail(f"K3 and K4 were handed {dtypes} on the RWKV path, not its "
             f"bf16 activations uncast")
    log(f"RWKV serve: prefill step median {serve['prefill_ms_median']:.2f} "
        f"ms, decode step median {serve['decode_ms_median']:.2f} ms, TTFT "
        f"p50 {per['ttft_ms']['p50']:.2f} ms, per token p50 "
        f"{per['per_token_ms']['p50']:.2f} ms")
    details["rwkv"] = {"serve": serve, "k4_checks": k4, "k2": k2,
                       "gemm_shapes": per_shape, "k1_split_sweep": sweep,
                       "k4_large": {big_label: k4_big},
                       "small_card_vs_cpu": small_out,
                       "bucket_24": bucket}
    return {"k4_row": k4_row, "launches": launches, "k2_times": k2["times"]}


def leaf_fingerprint(torch, leaf) -> tuple:
    """Two int64 sums of a leaf's bit patterns, plain and weighted by
    position, taken in chunks (a DLRM table stack holds 1.33e10 bytes):
    a changed element changes them, and a restored flip leaves both as
    they were."""
    from repro_torch.core.inject import signed_view

    flat = signed_view(leaf)
    s1 = torch.zeros((), dtype=torch.int64, device=leaf.device)
    s2 = torch.zeros_like(s1)
    step = 1 << 26
    for i in range(0, flat.numel(), step):
        c = flat[i:i + step].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return int(s1), int(s2)


def injection_seed(torch, leaf, path: str, reads, min_bit: int = 4) -> int:
    """The first seed from 0 whose :class:`FaultInjection` draw on
    ``leaf`` lands on an element ``reads(flat_index)`` says the requests
    read, at a bit of at least ``min_bit``: a fault in a row the request
    gathers, high in its byte, as the hand flips of earlier versions of
    this script chose.  The draws are the engine's own (a CPU generator
    per seed)."""
    from repro_torch.core.inject import draw_bitflip_live

    meta = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    for seed in range(1_000_000):
        idx, bit = draw_bitflip_live(torch.Generator().manual_seed(seed),
                                     meta, path)
        if bit >= min_bit and reads(idx):
            return seed
    fail(f"no injection seed below 1e6 hits a row the request reads "
         f"({path})")


def check_injection(tel, step: int, flagged_steps, fp_before, fp_after,
                    what: str) -> dict:
    """An injected fault flagged at its step (and only at
    ``flagged_steps``), the leaf bit-identical afterwards."""
    (inj,) = tel.injections
    flagged = sorted({ev.step for ev in tel.steps if ev.errors})
    if not inj.detected or inj.detect_step != step or \
            flagged != list(flagged_steps):
        fail(f"{what}: injected at step {inj.step}, detected "
             f"{inj.detected} at step {inj.detect_step}; flagged steps "
             f"{flagged}, expected {list(flagged_steps)}")
    if fp_after != fp_before:
        fail(f"{what}: the victim leaf {inj.victim} differs from its clean "
             f"value after the run")
    return {"victim": inj.victim, "step": inj.step,
            "detect_step": inj.detect_step, "flagged_steps": flagged,
            "persistent": inj.persistent,
            "counters": tel.summary()["faults"]["counters"]}


#: the campaign targets whose protected call launches K1 or K2 on the card
KERNEL_TARGETS = ("gemm_packed", "gemm_pallas", "embedding_bag", "eb_pallas")
#: at most this share of an EmbeddingBag cell's trials may be decided
#: differently by K2 and its plain version, each within
#: ``targets.EB_ROUND_OFF`` of the bound and explained by K2's own rsum
EB_SPLIT_SHARE = 0.01


def campaign_plans() -> list:
    """The distinct cell plans of the quick, pallas (quick) and paper grids
    at seed 0, as phase 9 runs them."""
    from repro_torch.campaign import grids, spec

    plans = {}
    for specs in (grids.quick_specs(seed=0),
                  grids.pallas_specs(seed=0, quick=True),
                  grids.paper_specs(seed=0)):
        for sp in specs:
            plans.update(dict.fromkeys(spec.expand(sp)[0]))
    return list(plans)


def kernels_at_campaign_shapes(torch, dev, plans) -> list:
    """K1 and K2 held to their plain versions at every shape the grids hand
    them, on the first cell state of each shape, built as the campaign
    builds it.  K1 (uint8 A, as the cells draw it): C, err_rows and the
    column check bit-exact with ``ref.abft_qgemm_ref``, clean (no row
    flagged) and with the cell's first fault in B'.  K2, on the cell's
    first trial's bags: :func:`eb_checks` (R bit-exact with the slot-order
    sum, rsum within round-off of the plain rsum, flags equal to the plain
    branch) and :func:`eb_flip_sweep`.  Returns what was held, by shape."""
    from repro_torch.campaign.executor import _generators
    from repro_torch.campaign.targets import get_target, inject_, restore_
    from repro_torch.core import LANE
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan

    first = {}
    for p in plans:
        if p.target in KERNEL_TARGETS:
            kind = "K1" if p.target.startswith("gemm") else "K2"
            first.setdefault((kind, p.shape), p)
    done = []
    for (kind, shape), p in first.items():
        target = get_target(p.target)
        g_build, g_trial, _ = _generators(p.seed)
        st = target.build(p, g_build, device=dev)
        (trial,) = target.draw(st, p, g_trial, 1, True)
        label = f"{p.target} {'x'.join(map(str, shape))}"
        if kind == "K2":
            enc = tuple(x[None] for x in st["enc"])
            bags = trial.indices[None].contiguous()
            eb_checks(torch, enc, bags, label)
            eb_flip_sweep(torch, enc, bags)
            done.append(f"K2 {label}")
            continue
        a, packed, n = st["a"], st["packed"], st["n"]
        faults = [f._replace(index=(f.index // n) * (n + LANE) + f.index % n)
                  for f in trial.faults]
        for faulty in (False, True):
            undo = inject_(signed_view(packed), faults, 8)[0] \
                if faulty else []
            for col in (False, True):
                got = abft_qgemm_cuda(a, packed, with_colcheck=col)
                want = ref.abft_qgemm_ref(a, packed, with_colcheck=col)
                for g, w, what in zip(got, want,
                                      ("C", "err_rows", "col_check")):
                    if not torch.equal(g, w):
                        fail(f"abft_qgemm: {what} differs from the plain "
                             f"version at {label} (a fault in B': "
                             f"{faulty}, column check {col})")
                if not faulty and int(got[1].sum()):
                    fail(f"abft_qgemm flagged clean operands at {label}")
            restore_(undo, 8)
        lp = launch_plan(*a.shape, n, a_addr=a.data_ptr(),
                         b_addr=packed.data_ptr())
        done.append(f"K1 {label} (bm {lp.bm}, splits {lp.splits}, "
                    f"aligned {lp.aligned})")
    return done


def eb_split_cause(torch, dev, plan, trial) -> dict:
    """Why K2 and its plain version decide an EmbeddingBag trial
    differently: K2 on the trial's faulted table and bags, its flags equal
    to its own Eq. (5) formula on its own rsum (``ref.eb_check_slot_order``),
    and the largest distance of that rsum from the float64 RSum, as a
    share of each bag's bound.  The split is the order of the sums alone
    when the flags equal the formula and that distance is within
    ``targets.EB_ROUND_OFF``."""
    from repro_torch.campaign.executor import _generators
    from repro_torch.campaign.targets import (eb_sums64, get_target,
                                              inject_, restore_)
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.protect.ops import EMBEDDING_BAG

    st = get_target(plan.target).build(plan, _generators(plan.seed)[0],
                                       device=dev)
    ((rsum64, _, bound64),) = eb_sums64(st, plan, [trial])
    table, al, be, rs = st["enc"]
    rel = EMBEDDING_BAG.default_rel_bound if plan.rel_bound is None \
        else plan.rel_bound
    undo, _ = inject_(signed_view(table), trial.faults, 8)
    idx = trial.indices[None].contiguous()
    _, rsum, flags, _ = abft_eb_cuda(table[None], al[None], be[None], idx,
                                     rs[None], rel_bound=rel)
    mirror = ref.eb_check_slot_order(rsum, al[None], be[None], idx, rs[None],
                                     table.shape[-1], rel_bound=rel)
    restore_(undo, 8)
    return {"k2_flagged": bool(flags.any()),
            "k2_flags_are_its_formula": torch.equal(flags, mirror),
            "k2_rsum_off_f64_of_bound": float(
                ((rsum[0].cpu().double() - rsum64).abs() / bound64).max())}


def trial_for_trial(torch, dev, plans) -> dict:
    """Every cell of the grids whose protected call launches K1 or K2, run
    twice on the card from its seed: with the kernels and with
    ``plain=True``.  The kernel run must launch one kernel per trial and
    the plain run none; the corrupted and the clean flags must be equal,
    and the GEMM's detection flags bit for bit.  An EmbeddingBag trial may
    be decided differently only within ``targets.EB_ROUND_OFF`` of its
    bound, by at most :data:`EB_SPLIT_SHARE` of the cell's trials, and
    only where :func:`eb_split_cause` shows K2 deciding by its own formula
    on an rsum within round-off of the float64 one.  The trials inside
    that window are counted, agreeing and differing."""
    import dataclasses

    from repro_torch.campaign.executor import _generators, run_cell
    from repro_torch.campaign.targets import (EB_ROUND_OFF, eb_margins,
                                              get_target)
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda

    out = {}
    for plan in plans:
        if plan.target not in KERNEL_TARGETS:
            continue
        cid = f"{plan.cell_id} n={plan.samples}"
        plan = dataclasses.replace(plan, measure_overhead=False)
        runs, launched = {}, {}
        for plain in (False, True):
            abft_qgemm_cuda.launches = abft_eb_cuda.launches = 0
            runs[plain] = run_cell(plan, device=dev, plain=plain)
            launched[plain] = (abft_qgemm_cuda.launches
                               + abft_eb_cuda.launches)
        n = plan.samples + plan.clean_samples
        if launched[False] != n or launched[True] != 0:
            fail(f"{cid}: kernel launches {launched} (the kernel run must "
                 f"launch one per trial, {n}, the plain run none)")
        k, p = runs[False], runs[True]
        if not torch.equal(k.trials[:, 1], p.trials[:, 1]):
            fail(f"{cid}: the kernel and plain runs corrupted different "
                 f"trials")
        if not torch.equal(k.clean, p.clean):
            fail(f"{cid}: clean flags differ between kernel and plain "
                 f"({int((k.clean != p.clean).sum())} of "
                 f"{plan.clean_samples})")
        differ = (k.trials[:, 0] != p.trials[:, 0]).nonzero()[:, 0].tolist()
        row = {"target": plan.target, "trials": plan.samples,
               "clean": plan.clean_samples,
               "detected_kernel": int(k.trials[:, 0].sum()),
               "detected_plain": int(p.trials[:, 0].sum()),
               "differ": differ}
        out[cid] = row
        if plan.target.startswith("gemm"):
            if differ:
                fail(f"{cid}: {len(differ)} trials decided differently by "
                     f"K1 and its plain version")
            continue
        target = get_target(plan.target)
        g_build, g_trial, _ = _generators(plan.seed)
        state = target.build(plan, g_build, device=dev)
        trials = target.draw(state, plan, g_trial, plan.samples, True)
        margins = eb_margins(state, plan, trials)
        window = [i for i, m in enumerate(margins) if abs(m) <= EB_ROUND_OFF]
        causes = {i: eb_split_cause(torch, dev, plan, trials[i])
                  for i in differ}
        row.update(in_window=len(window),
                   in_window_differ=len(set(window) & set(differ)),
                   margins_of_differing=[margins[i] for i in differ],
                   causes=causes)
        cap = max(1, int(EB_SPLIT_SHARE * plan.samples))
        if len(differ) > cap or not set(differ) <= set(window):
            fail(f"{cid}: K2 and its plain version decide trials {differ} "
                 f"differently, margins {row['margins_of_differing']} "
                 f"({len(window)} trials within {EB_ROUND_OFF} of the "
                 f"bound; at most {cap} may differ, all inside it)")
        for i, c in causes.items():
            if c["k2_flagged"] != bool(k.trials[i, 0]) or \
                    not c["k2_flags_are_its_formula"] or \
                    c["k2_rsum_off_f64_of_bound"] > EB_ROUND_OFF:
                fail(f"{cid}: trial {i}, decided differently by K2 and its "
                     f"plain version, is not a split of round-off: {c}")
    return out


def campaign_phase(torch, dev, out_dir) -> dict:
    """Phase 9: the port's quick, pallas (quick) and paper grids on the
    card through K1 and K2, at the JAX grids' sample counts and seed 0;
    every main-path cell of the two committed JAX baselines held to its
    baseline by overlapping Wilson intervals (detection and FP); the
    port's differ record at its default tolerances printed beside it;
    then K1 and K2 against their plain versions at every shape the grids
    hand them, and the kernel and plain runs of every cell that launches
    them, trial for trial."""
    from repro_torch.campaign import grids
    from repro_torch.campaign.artifacts import load_artifact
    from repro_torch.campaign.diff import (diff_artifacts, format_diff,
                                           wilson_gate)
    from repro_torch.campaign.executor import run_campaign

    wrappers = zero_launches()
    t0 = time.perf_counter()
    runs = {name: run_campaign(name, specs, device=dev, out_dir=out_dir)
            for name, specs in (
                ("quick", grids.quick_specs(seed=0)),
                ("pallas_quick", grids.pallas_specs(seed=0, quick=True)),
                ("paper", grids.paper_specs(seed=0)))}
    launches = read_launches(wrappers)
    seconds = time.perf_counter() - t0
    log(f"campaign grids on the card in {seconds:.1f}s: "
        + ", ".join(f"{k} {len(v['cells'])} cells" for k, v in runs.items())
        + f"; launches {launches}"
        + (f"; artifacts in {out_dir}" if out_dir else ""))
    if launches["abft_qgemm"] <= 0 or launches["abft_embeddingbag"] <= 0:
        fail(f"the campaign did not run through K1 and K2: {launches}")

    cells = {}
    for name, res in runs.items():
        for c in res["cells"]:
            m = c["metrics"]
            bd = m.get("overhead_breakdown") or {}
            cells[c["cell_id"] if name != "pallas_quick"
                  else "pallas:" + c["cell_id"]] = {
                "detection_rate": m["detection_rate"], "ci95": m["ci95"],
                "fp_rate": m["fp_rate"], "samples": m["samples"],
                "clean_samples": m["clean_samples"],
                "analytic_bound": m.get("analytic_bound"),
                "overhead": m.get("overhead"),
                "protected_ms": (m["protected_s"] * 1e3
                                 if m.get("protected_s") else None),
                "unprotected_ms": (m["unprotected_s"] * 1e3
                                   if m.get("unprotected_s") else None),
                "phases_ms": {k: v * 1e3 for k, v in bd.items()}}
            ov = m.get("overhead")
            log(f"  [{name}] {c['cell_id']}: detect "
                f"{m['detection_rate']:.4f} (n {m['samples']}, ci "
                f"{m['ci95'][0]:.4f}-{m['ci95'][1]:.4f}), fp "
                f"{m['fp_rate']:.4f} (n {m['clean_samples']})"
                + ("" if ov is None else
                   f", overhead {ov:+.4f} (protected "
                   f"{m['protected_s'] * 1e3:.4f} ms, unprotected "
                   f"{m['unprotected_s'] * 1e3:.4f} ms by CUDA events)")
                + ("" if not bd else "; phases ms " + ", ".join(
                    f"{k} {v * 1e3:.4f}" for k, v in bd.items())))

    gates = {}
    base_dir = ROOT / "benchmarks" / "baselines"
    for name, n_cells in (("pallas_quick", 7), ("quick", 10)):
        base = load_artifact(str(base_dir / f"BENCH_campaign_{name}.json"))
        gate = wilson_gate(base, runs[name])
        diff = diff_artifacts(base, runs[name])
        for line in format_diff(diff).splitlines():
            if line:
                log(f"  | {line}")
        overlap = {c["cell_id"]: c for c in gate["cells"]}
        det_regressed = sorted(r["cell_id"] for r in diff["regressions"]
                               if r["kind"] == "detection_rate")
        # the differ's verdict at det_tol 0.02 against the Wilson gate
        disagree = [cid for cid in overlap
                    if (cid in det_regressed)
                    == overlap[cid]["detection"]["overlap"]]
        log(f"  Wilson gate vs {name}: {len(gate['cells'])} cells, failed "
            f"{gate['failed']}, uncovered {gate['uncovered']}; differ at "
            f"det_tol 0.02 disagrees with the gate on {disagree}")
        gates[name] = {"failed": gate["failed"],
                       "uncovered": gate["uncovered"],
                       "differ_regressions": diff["regressions"],
                       "differ_disagrees_with_wilson": disagree,
                       "cells": gate["cells"]}
        if len(gate["cells"]) != n_cells or gate["failed"]:
            fail(f"campaign vs the {name} baseline: {len(gate['cells'])} of "
                 f"{n_cells} cells gated, failing Wilson overlap: "
                 f"{gate['failed']}")
    t1 = time.perf_counter()
    plans = campaign_plans()
    shapes = kernels_at_campaign_shapes(torch, dev, plans)
    log(f"K1 and K2 against their plain versions at all {len(shapes)} "
        f"shapes the grids hand them ({time.perf_counter() - t1:.1f}s): "
        + "; ".join(shapes))
    t1 = time.perf_counter()
    tft = trial_for_trial(torch, dev, plans)
    gemm = [v for v in tft.values() if v["target"].startswith("gemm")]
    log(f"kernel vs plain, trial for trial on the card "
        f"({time.perf_counter() - t1:.1f}s): {len(gemm)} K1 cells, "
        f"{sum(v['trials'] + v['clean'] for v in gemm)} trials, every flag "
        f"equal; K2 cells: " + "; ".join(
            f"{cid}: {v['detected_kernel']}/{v['trials']} and "
            f"{v['detected_plain']}/{v['trials']} detected, "
            f"{v['in_window']} trials within round-off of the bound "
            f"({v['in_window'] - v['in_window_differ']} agree, "
            f"{v['in_window_differ']} differ: {v['differ']}, margins "
            f"{v['margins_of_differing']}, causes {v['causes']})"
            for cid, v in tft.items() if not v["target"].startswith("gemm")))
    return {"launches": launches, "seconds": seconds, "cells": cells,
            "gates": gates, "kernel_shapes": shapes, "trial_for_trial": tft}


#: the bound at which float32 round-off decides a clean bag's Eq. (5) flag
#: (ROADMAP §C2): the thresholds gate holds K2 to its own formula there
ROUND_OFF_BOUND = 1e-7


def thresholds_phase(torch, dev, out_dir) -> dict:
    """Phase 10: the port's ``thresholds`` grid on the card (15 EB cells,
    rel_bound 1e-7 to 1e-3, 400 faulty and 400 clean trials each, seed
    0), held to the committed JAX baseline by overlapping 95% Wilson
    intervals: detection in every cell, false positives at 1e-6 to 1e-3.
    At 1e-7 (ROADMAP §C2) round-off decides the clean bags, so the FP rate
    is printed beside the baseline's interval and the plain branch's, not
    gated against them; instead every trial of those cells is replayed
    through K2 and its flags held, bag for bag, to K2's own Eq. (5) formula
    on its own rsum (``ref.eb_check_slot_order``), and its decisions to
    the campaign's.  Returns the counts and the launches of the grid's
    run (counted from zero)."""
    from repro_torch.campaign import grids
    from repro_torch.campaign.artifacts import (load_artifact,
                                                threshold_curve,
                                                threshold_curve_markdown)
    from repro_torch.campaign.diff import wilson_gate
    from repro_torch.campaign.executor import (_generators, run_campaign,
                                               run_cell)
    from repro_torch.campaign.metrics import wilson_interval
    from repro_torch.campaign.spec import expand
    from repro_torch.campaign.targets import get_target, inject_, restore_
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda

    specs = grids.thresholds_specs(seed=0)
    wrappers = zero_launches()
    t0 = time.perf_counter()
    res = run_campaign("thresholds", specs, device=dev, out_dir=out_dir)
    launches = read_launches(wrappers)
    seconds = time.perf_counter() - t0
    if launches["abft_embeddingbag"] != 15 * 800:
        fail(f"the thresholds grid launched K2 "
             f"{launches['abft_embeddingbag']} times, not one per trial "
             f"(12000): {launches}")
    for line in threshold_curve_markdown(res).splitlines():
        log(f"  | {line}")
    base = load_artifact(str(ROOT / "benchmarks" / "baselines"
                             / "BENCH_campaign_thresholds.json"))
    gate = wilson_gate(base, res)
    if len(gate["cells"]) != 15 or gate["uncovered"]:
        fail(f"thresholds: {len(gate['cells'])} of 15 cells gated, "
             f"uncovered {gate['uncovered']}")
    failed = []
    for c in gate["cells"]:
        rb = float(c["cell_id"].rsplit("/rb", 1)[1])
        ok = c["detection"]["overlap"] and (
            rb == ROUND_OFF_BOUND or c["fp"]["overlap"])
        log(f"  thresholds {c['cell_id']}: detection card "
            f"{c['detection']['new']} vs JAX {c['detection']['old']}; FP "
            f"card {c['fp']['new']} vs JAX {c['fp']['old']}"
            + (" (not gated: §C2)" if rb == ROUND_OFF_BOUND else "")
            + ("" if ok else "  FAILED"))
        if not ok:
            failed.append(c["cell_id"])
    if failed:
        fail(f"thresholds cells outside the JAX baseline's intervals: "
             f"{failed}")

    round_off = {}
    plans = [p for p in expand(specs[0])[0] if p.rel_bound == ROUND_OFF_BOUND]
    for plan in plans:
        k = run_cell(plan, device=dev)
        p = run_cell(plan, device=dev, plain=True)
        target = get_target(plan.target)
        g_build, g_trial, g_clean = _generators(plan.seed)
        st = target.build(plan, g_build, device=dev)
        table, al, be, rs = st["enc"]
        runs = (("faulty", target.draw(st, plan, g_trial, plan.samples,
                                       True), k.trials[:, 0]),
                ("clean", target.draw(st, plan, g_clean,
                                      plan.clean_samples, False), k.clean))
        row = {}
        for kind, trials, decided in runs:
            rsums, flags = [], []
            for t in trials:
                undo, _ = inject_(signed_view(table), t.faults, 8)
                _, rsum, f, _ = abft_eb_cuda(
                    table[None], al[None], be[None], t.indices[None],
                    rs[None], rel_bound=plan.rel_bound)
                restore_(undo, 8)
                rsums.append(rsum[0])
                flags.append(f[0])
            rsum, flags = torch.stack(rsums), torch.stack(flags)
            idx = torch.stack([t.indices for t in trials])
            n = len(trials)
            mirror = ref.eb_check_slot_order(
                rsum, al.expand(n, -1), be.expand(n, -1), idx,
                rs.expand(n, -1), table.shape[-1],
                rel_bound=plan.rel_bound)
            if not torch.equal(flags, mirror):
                fail(f"{plan.cell_id} ({kind}): K2's flags differ from its "
                     f"own Eq. (5) formula on {int((flags != mirror).sum())}"
                     f" bags")
            if not torch.equal(flags.any(-1).cpu(), decided):
                fail(f"{plan.cell_id} ({kind}): the replay decided "
                     f"{int((flags.any(-1).cpu() != decided).sum())} trials "
                     f"otherwise than the campaign run")
            row[kind] = {"trials": n, "flagged": int(decided.sum()),
                         "bags_flagged": int(flags.sum())}
        fp_k, fp_p = int(k.clean.sum()), int(p.clean.sum())
        b = next(c for c in base["cells"] if c["cell_id"] == plan.cell_id)
        bm = b["metrics"]
        row.update(
            card_fp=fp_k / plan.clean_samples,
            card_fp_ci95=wilson_interval(fp_k, plan.clean_samples),
            plain_fp=fp_p / plan.clean_samples,
            plain_fp_ci95=wilson_interval(fp_p, plan.clean_samples),
            jax_fp=bm["fp_rate"],
            jax_fp_ci95=wilson_interval(bm["false_positives"],
                                        bm["clean_samples"]))
        round_off[plan.cell_id] = row
        log(f"  §C2 {plan.cell_id}: K2 FP {row['card_fp']:.4f} "
            f"{row['card_fp_ci95']}, plain branch {row['plain_fp']:.4f} "
            f"{row['plain_fp_ci95']}, JAX CPU baseline {row['jax_fp']:.4f} "
            f"{row['jax_fp_ci95']}; K2's flags equal its own formula on "
            f"its own rsum in all {row['faulty']['trials']} faulty and "
            f"{row['clean']['trials']} clean trials "
            f"({row['clean']['bags_flagged']} clean bags flagged)")
    log(f"thresholds grid on the card in {seconds:.1f}s: 15 cells gated "
        f"(detection 15, FP 12), launches {launches}")
    return {"launches": launches, "seconds": seconds, "gate": gate,
            "round_off": round_off, "curve": threshold_curve(res)}


#: an overhead median below this means the timing, not the check, is wrong
MIN_OVERHEAD = -0.05


def overhead_phase(torch, dev, timer) -> dict:
    """Phase 11: the paper's overhead benchmarks on the card
    (``repro_torch.benchmarks``): Fig. 5 over the 28 DLRM GEMM shapes and
    Table I over d 32-256 on 4M-row tables, each protected kernel against
    its own unprotected instance by CUDA events in alternating rounds.
    Both tables are printed in full; every cell must hold the unprotected
    result bit-exact to the protected kernel's (C's first n columns, R),
    and no median overhead may read below :data:`MIN_OVERHEAD`.  Then the
    two instances are held to their plain versions at every shape the
    benchmarks hand them and timed for the kernels line."""
    from repro_torch.benchmarks import eb_overhead, gemm_overhead
    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import eb_unprotected_cuda
    from repro_torch.kernels.abft_qgemm import qgemm_unprotected_cuda

    wrappers = zero_launches()
    t0 = time.perf_counter()
    gemm = gemm_overhead.run(dev, timer=timer)
    eb = eb_overhead.run(dev, timer=timer)
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    for line in (gemm_overhead.table(gemm) + "\n"
                 + eb_overhead.table(eb)).splitlines():
        log(f"  | {line}")
    bad = [r["shape"] for r in gemm if not r["exact"]] + \
        [(r["d"], r["mode"]) for r in eb if not r["exact"]]
    if bad:
        fail(f"an unprotected instance differs from its protected kernel "
             f"at {bad}")
    low = [(r["shape"], k, r[k]["median"]) for r in gemm
           for k in ("overhead_cold", "overhead_warm", "overhead_encode")
           if r[k]["median"] < MIN_OVERHEAD] + \
        [((r["d"], r["mode"]), "overhead", r["overhead"]["median"])
         for r in eb if r["overhead"]["median"] < MIN_OVERHEAD]
    if low:
        fail(f"a protected kernel timed faster than its unprotected "
             f"instance: {low}")
    log(f"overhead benchmarks in {seconds:.1f}s: {len(gemm)} GEMM shapes, "
        f"{len(eb)} EB cells; unprotected results bit-exact; launches "
        f"{launches}")
    if min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                 "qgemm_unprotected", "eb_unprotected")) <= 0:
        fail(f"the overhead benchmarks did not run through their kernels: "
             f"{launches}")

    # the instances against their plain versions, at the benchmarks' shapes
    # and inputs, and timed for the kernels line (warm GEMM, cold EB)
    cases = []
    for m, n, k in gemm_overhead.GEMM_SHAPES:
        a, _, bp = gemm_overhead.operands(m, n, k, dev)
        cases.append((a, bp))
    for a, bp in cases:
        if not torch.equal(qgemm_unprotected_cuda(a, bp),
                           ref.qgemm_ref(a, bp)):
            fail(f"qgemm_unprotected differs from its plain version at "
                 f"{tuple(a.shape)} x {tuple(bp.shape)}")
    g_bytes = sum(gemm_overhead.unprotected_bytes(*r["shape"]) for r in gemm)
    g_ops = sum(2 * m * n * k for m, n, k in gemm_overhead.GEMM_SHAPES)
    eb_cases, eb_err, e_bytes, e_ops = [], 0.0, 0, 0
    for d in eb_overhead.DIMS:
        enc = eb_overhead.make_table(eb_overhead.ROWS, d, dev)
        gen = torch.Generator(device=dev).manual_seed(d + 1)
        for weighted in (False, True):
            idx = torch.randint(0, eb_overhead.ROWS, (1, eb_overhead.BATCH,
                                                      eb_overhead.POOL),
                                dtype=torch.int32, generator=gen,
                                device=dev)
            w = (torch.rand(idx.shape, generator=gen, device=dev) + 0.5
                 if weighted else None)
            args = (enc[0], enc[1], enc[2], idx, w)
            r = eb_unprotected_cuda(*args)
            if not torch.equal(r, ref.abft_eb_slot_order_ref(*args)):
                fail(f"eb_unprotected differs from the slot-order sum at "
                     f"d {d} ({'weighted' if weighted else 'regular'})")
            plain = ref.eb_ref(*args)
            err = float((r - plain).abs().max())
            scale = max(1.0, float(plain.abs().max()))
            if err > 1e-5 * eb_overhead.POOL * scale:
                fail(f"eb_unprotected off its plain version by {err} at d "
                     f"{d}")
            eb_err = max(eb_err, err)
            eb_cases.append(args)
            e_bytes += eb_overhead.unprotected_bytes(d, weighted)
            e_ops += 3 * eb_overhead.BATCH * eb_overhead.POOL * d

    def seq(fn, cs):
        return lambda: [fn(*c) for c in cs]

    try:
        library = timer.ms(seq(torch._int_mm, [
            gemm_overhead.int_mm_operands(a, bp) for a, bp in cases]), 10)
    except RuntimeError as e:
        log(f"torch._int_mm refused a padded Fig. 5 shape: {e}")
        library = None
    rows = [
        {"name": "qgemm_unprotected", "source":
         "src/repro_torch/csrc/abft_qgemm.cu", "replaces":
         "benchmarks/gemm_overhead.py:40", "max_abs_err": 0.0,
         "ms": timer.ms(seq(qgemm_unprotected_cuda, cases), 10),
         "plain_ms": timer.ms(seq(ref.qgemm_ref, cases), 5),
         "bound": bound_ms(g_bytes, g_ops, INT8_OPS_PER_S),
         "library_ms": library,
         "per": "the 28 Fig. 5 shapes, one launch each, uint8 A, warm"},
        {"name": "eb_unprotected", "source":
         "src/repro_torch/csrc/abft_embeddingbag.cu", "replaces":
         "src/repro/core/abft_embedding.py:61", "max_abs_err": eb_err,
         "ms": timer.ms(seq(eb_unprotected_cuda, eb_cases), 10),
         "plain_ms": timer.ms(seq(ref.eb_ref, eb_cases), 5),
         "bound": bound_ms(e_bytes, e_ops, F32_OPS_PER_S),
         "library_ms": None,
         "per": "the 8 Table I cells (d 32-256, regular and weighted), "
                "one launch each, 4M-row tables"}]
    return {"gemm": gemm, "eb": eb, "seconds": seconds, "rows": rows,
            "launches": launches}


def float_dlrm_phase(torch, dev, ex, tables) -> dict:
    """Phase 12: the full-width float DLRM (``init_dlrm(..., quant=False)``:
    float bottom and top MLPs over phase 3's 26 x 4M x 128 int8 tables,
    not a second set) on 8 batches of ``SyntheticDLRMDataset``.  With
    ``float_gemm`` on (each layer's row sums encoded once,
    ``encode_linear``): 0 errors on the clean batches; a high exponent bit
    of one ``top.0`` weight flipped in place is flagged with the rule on
    at ``top.0`` alone, and not with it on everywhere else; restored, 0
    errors again.  Then the model converted by ``quantize_dlrm``
    (``quantize_linear`` per layer) serves the same batches through K1-K3
    with 0 errors; the gap between the float and int8 CTR scores is
    printed.  Returns the figures and the int8 run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.dlrm import CONFIG
    from repro_torch.core.inject import flip_bit_
    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.data import DataConfig, SyntheticDLRMDataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.layers.common import Ctx
    from repro_torch.layers.linear import apply_linear, encode_linear
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm, \
        quantize_dlrm
    from repro_torch.protect import ProtectionPlan, default_plan

    t0 = time.perf_counter()
    p = init_dlrm(7, ex, quant=False, tables=tables, device=dev)
    p = dict(p, bottom=[encode_linear(lp) for lp in p["bottom"]],
             top=[encode_linear(lp) for lp in p["top"]])
    ds = SyntheticDLRMDataset(CONFIG, ShapeConfig("serve", "prefill", 1,
                                                  ex.batch),
                              DataConfig(seed=0))
    batches = [to_device(ds.batch_at(s), dev) for s in range(8)]
    f32 = torch.float32

    def ctx(plan, dtype=f32):
        return Ctx(plan=ProtectionPlan.parse(plan), compute_dtype=dtype)

    def run(params, c, which=None):
        out, counts = [], []
        for b in (batches if which is None else [batches[which]]):
            logit, rep = dlrm_forward(params, b["dense"], b["bags"], c, ex)
            out.append(logit.float())
            counts.append(metrics_to_ints(rep.as_metrics()))
        total = {k: sum(c_[k] for c_ in counts) for k in counts[0]}
        return torch.cat(out), total

    layers = len(ex.bottom_mlp) + len(ex.top_mlp)
    logit_f, clean = run(p, ctx("float_gemm:on"))
    if clean["abft/float_gemm_checks"] != 8 * layers or \
            clean["abft/float_gemm_errors"] or clean["abft/eb_errors"] or \
            not bool(torch.isfinite(logit_f).all()):
        fail(f"float DLRM, clean: {clean}")
    # the top.0 input column the flip meets: the bottom MLP's largest mean
    # output feature of the first batch (|x| well below the f32 range
    # times 2**128 of the flipped weight)
    x = batches[0]["dense"].float()
    for i, lp in enumerate(p["bottom"]):
        x, _ = apply_linear(lp, x, ctx("off"))
        x = torch.relu(x)
    k0 = int(x.mean(0).argmax())
    w = p["top"][0]["w"]
    at, bit = k0 * w.shape[1] + 3, 30
    if float(w.view(-1)[at].abs()) >= 2.0 or float(x[:, k0].max()) > 100:
        fail("float DLRM flip: the chosen weight or input is out of range")
    before = w.clone()
    flip_bit_(w, at, bit)
    _, at_top0 = run(p, ctx("float_gemm/top.0:on"), which=0)
    _, elsewhere = run(p, ctx("float_gemm:on,float_gemm/top.0:off"), which=0)
    flip_bit_(w, at, bit)
    if not torch.equal(w, before):
        fail("float DLRM flip: the weight was not restored")
    _, again = run(p, ctx("float_gemm:on"))
    if at_top0["abft/float_gemm_errors"] < 1 or \
            elsewhere["abft/float_gemm_errors"] or \
            again["abft/float_gemm_errors"]:
        fail(f"float DLRM flip of top.0.w[{k0}, 3] bit {bit}: errors with "
             f"the rule at top.0 {at_top0}, elsewhere {elsewhere}, after "
             f"the restore {again}")

    q = quantize_dlrm(p)
    wrappers = zero_launches()
    logit_q, served = run(q, Ctx(quant=True, plan=default_plan(),
                                 compute_dtype=torch.bfloat16))
    launches = read_launches(wrappers)
    if served["abft/qgemm_checks"] != 8 * layers or \
            served["abft/qgemm_errors"] or served["abft/eb_errors"] or \
            min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                      "quantize_rows")) <= 0 or \
            not bool(torch.isfinite(logit_q).all()):
        fail(f"the int8 conversion of the float DLRM: {served}, launches "
             f"{launches}")
    ctr_f, ctr_q = torch.sigmoid(logit_f), torch.sigmoid(logit_q)
    gap = {"logit_max_abs": float((logit_f - logit_q).abs().max()),
           "logit_scale": float(logit_f.abs().max()),
           "ctr_max_abs": float((ctr_f - ctr_q).abs().max()),
           "ctr_mean_abs": float((ctr_f - ctr_q).abs().mean())}
    seconds = time.perf_counter() - t0
    log(f"float DLRM ({ex.n_tables} x {ex.table_rows} x {ex.emb_dim} tables "
        f"shared with phase 3) on 8 batches of {ex.batch} in "
        f"{seconds:.1f}s: float_gemm {clean['abft/float_gemm_checks']} "
        f"checks, 0 errors; top.0.w[{k0}, 3] bit {bit} flipped: "
        f"{at_top0['abft/float_gemm_errors']} rows flagged at top.0, 0 "
        f"elsewhere, 0 after the restore; int8 by quantize_linear through "
        f"K1-K3: {served['abft/qgemm_checks']} checks, 0 errors, launches "
        f"{launches}; float vs int8 CTR: max |d| {gap['ctr_max_abs']:.3g}, "
        f"mean {gap['ctr_mean_abs']:.3g} (logits max |d| "
        f"{gap['logit_max_abs']:.3g} of scale {gap['logit_scale']:.3g})")
    return {"seconds": seconds, "clean": clean, "flip": {
        "weight": f"top.0.w[{k0}, 3]", "bit": bit,
        "flagged_rows_at_top0": at_top0["abft/float_gemm_errors"]},
        "int8": served, "gap": gap, "launches": launches}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("no CUDA device is available; nothing to drive")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.dlrm import CONFIG, EXTRAS
    from repro_torch.core import LANE, pack_encoded_b
    from repro_torch.kernels import _build, ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.protect import default_plan
    from repro_torch.serving import ServingEngine, TenantSpec, dlrm_stream

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    details = {"card": smi_line()}
    print(details["card"], flush=True)

    # ------------------------------ 2. build --------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    details["build_s"] = time.perf_counter() - t0
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        log(f"built {name} in {info['seconds']:.1f}s; " + "; ".join(regs))
    log(f"build wall {details['build_s']:.1f}s")

    # ---------------------- 3. kernels vs plain versions --------------------
    ex = EXTRAS
    t0 = time.perf_counter()
    engine = ServingEngine(CONFIG, [TenantSpec("default", default_plan())],
                           seed=0, device=dev)
    torch.cuda.synchronize()
    details["init_s"] = time.perf_counter() - t0
    params = engine.params
    tables = params["tables"]
    log(f"full-width DLRM on the card in {details['init_s']:.1f}s: tables "
        f"{tuple(tables['table'].shape)}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    layers = params["bottom"] + params["top"]
    shapes = [(p["w_packed"].shape[0], p["w_packed"].shape[1] - LANE)
              for p in layers]
    if shapes != [(13, 512), (512, 256), (256, 128), (479, 1024),
                  (1024, 1024), (1024, 512), (512, 256), (256, 1)]:
        fail(f"unexpected DLRM layer shapes {shapes}")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 10                                         # dlrm_stream lookup batch
    errs = {"abft_qgemm": 0.0, "quantize_rows": 0.0, "abft_embeddingbag": 0.0}

    def check_equal(name, got, want, what):
        if got.shape != want.shape or not torch.equal(got, want):
            bad = (got != want).sum().item() if got.shape == want.shape \
                else "shape"
            fail(f"{name}: {what} differs from the plain version ({bad})")

    def rand_i8(rows, cols, dtype=torch.int8):
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, (rows, cols), generator=gen,
                             device=dev).to(dtype)

    # K1: every layer at m = 10 in int8 (the path's type) and uint8, each
    # with and without the column check (two variants of the kernel); an
    # aligned RWKV shape split across a cluster; A off 16-byte alignment;
    # and the larger m = 2048 shape on top.1
    k1_main = [(rand_i8(m, k), p["w_packed"]) for (k, _), p in
               zip(shapes, layers)]
    k1_cases = k1_main + [(rand_i8(m, k, torch.uint8), p["w_packed"])
                          for (k, _), p in zip(shapes, layers)]
    bp_rwkv = pack_encoded_b(torch.randint(-127, 128, (2048, 2048),
                                           generator=gen, device=dev)
                             .to(torch.int8))
    k1_cases.append((rand_i8(64, 2048), bp_rwkv))
    a_off = torch.empty(64 * 2048 + 16, dtype=torch.int8, device=dev)
    a_off = a_off[1:1 + 64 * 2048].view(64, 2048)
    a_off.copy_(rand_i8(64, 2048))
    k1_cases.append((a_off, bp_rwkv))
    a_big, bp_big = rand_i8(2048, 1024), layers[4]["w_packed"]
    k1_cases.append((a_big, bp_big))
    paths = set()
    for a, bp in k1_cases:
        plan = launch_plan(a.shape[0], a.shape[1], bp.shape[1] - LANE,
                           a_addr=a.data_ptr(), b_addr=bp.data_ptr())
        paths.add((plan.bm, plan.splits, plan.aligned))
        for col in (False, True):
            got = abft_qgemm_cuda(a, bp, with_colcheck=col)
            want = ref.abft_qgemm_ref(a, bp, with_colcheck=col)
            for g, w, what in zip(got, want, ("C", "err_rows", "col_check")):
                check_equal("abft_qgemm", g, w,
                            f"{what} at {tuple(a.shape)} {a.dtype} "
                            f"(k, n) = {(bp.shape[0], bp.shape[1] - LANE)} "
                            f"col_check={col}")
            if int(got[1].sum()) != 0:
                fail("abft_qgemm flagged clean operands")
    bad_bp = layers[3]["w_packed"].clone()
    bad_bp[100, 200] ^= 0x08                       # payload bit, stale lane
    a = k1_main[3][0]
    got, want = abft_qgemm_cuda(a, bad_bp), ref.abft_qgemm_ref(a, bad_bp)
    check_equal("abft_qgemm", got[1], want[1], "err_rows under a flip")
    if int(got[1].sum()) == 0:
        fail("abft_qgemm missed a flipped weight bit")
    log(f"K1 bit-exact in C, err_rows and the column check on "
        f"{len(k1_cases)} cases, each with and without the check; plans "
        f"(bm, splits, aligned) {sorted(paths)}; flip flags "
        f"{int(got[1].sum())}/{m} rows as the plain version does")

    # K3: the input width of every layer at m = 10, in bf16 as the path
    # hands it over and in its f32 cast, and one larger f32 shape
    k3_inputs = [torch.randn((m, k), generator=gen, device=dev)
                 .to(torch.bfloat16) for k, _ in shapes]
    k3_inputs.append(torch.randn((2048, 1024), generator=gen, device=dev))
    k3_cases = k3_inputs + [x.float() for x in k3_inputs[:len(shapes)]]
    for x in k3_cases:
        for g, w, what in zip(quantize_rows_cuda(x), ref.quantize_rows_ref(x),
                              ("q", "alpha", "beta")):
            check_equal("quantize_rows", g, w,
                        f"{what} at {tuple(x.shape)} {x.dtype}")
    log(f"K3 bit-exact in q, alpha, beta on {len(k3_cases)} cases (every "
        f"layer width in bf16 and f32)")
    hazards = pdl_hazards(torch, dev, gen, [
        (f"layer {i} (k, n) = {shapes[i]} m = {m}", m,
         layers[i]["w_packed"]) for i in (0, 3, 7)])
    log("K1 under PDL bit-exact after K3, after an in-place flip of B', "
        "after K1 on the same scratch and after the correct repair at "
        + "; ".join(hazards))

    # K2: one request's bags over all 26 full tables, then the paper's
    # Table I pooling (2048 bags x 100) over all of them
    def stream(n, seed):
        return dlrm_stream(n, tenants={"default": 1.0}, seed=seed,
                           lookup_batch=m, table_rows=ex.table_rows,
                           n_tables=ex.n_tables)

    req_bags = torch.from_numpy(stream(1, 5)[0].payload["bags"]).to(dev)
    big_bags = torch.randint(0, ex.table_rows, (ex.n_tables, 2048, 100),
                             generator=gen, device=dev, dtype=torch.int32)
    enc = (tables["table"], tables["alphas"], tables["betas"])
    enc4 = enc + (tables["rowsums"],)
    past = req_bags.clone()                        # past the table: last row
    past[0, 0, 0], past[-1, -1, 0] = ex.table_rows + 7, 2**31 - 1
    k2_checks = {}
    for label, bags in (("request", req_bags), ("Table I", big_bags)):
        k2_checks[label] = eb_checks(torch, enc4, bags,
                                     f"{label} {tuple(bags.shape)}")
    want = ref.abft_eb_slot_order_ref(*enc, past)
    if not torch.equal(abft_eb_cuda(*enc4[:3], past, enc4[3])[0], want):
        fail("abft_embeddingbag: an index past the table did not read its "
             "last row")
    k2_flips = eb_flip_sweep(torch, enc4, req_bags)
    eb_pdl_hazards(torch, enc4, req_bags)
    errs["abft_embeddingbag"] = k2_checks["request"]["rsum_max_abs_err"]
    details["k2_checks"] = {**k2_checks, "flip_sweep_flagged": k2_flips}
    log(f"K2 at {tuple(req_bags.shape)} and {tuple(big_bags.shape)}: R "
        f"bit-exact with the slot-order sum (and past the table), rsum "
        f"within 1e-5 x d x max|R| (max |d| "
        f"{errs['abft_embeddingbag']:.3g}), flags and counts equal to the "
        f"plain branch at rel_bound 1e-3 and 1e-5 and to its formula on its "
        f"own rsum at 1e-3, 1e-5 and 1e-7 (at 1e-7 "
        + ", ".join(f"{k}: {v['flagged_at_1e-7']} flagged, plain branch "
                    f"differs on {v['plain_branch_differs_at_1e-7']}"
                    for k, v in k2_checks.items())
        + f"); bits 0-7 of a table byte flipped: bags flagged {k2_flips} "
          f"as the plain branch flags them; under PDL right after a table "
          f"flip, an alpha change and another K2")

    # ----------------------------- 4. serve ---------------------------------
    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))
    launches = read_launches(wrappers)
    s = tel.summary()
    per = s["per_tenant"]["default"]
    counters = s["faults"]["counters"]
    log(f"served {per['requests']} requests: {per['completed']} completed; "
        f"launches {launches}; counters "
        f"{ {k: v for k, v in counters.items() if v} }")
    if per["completed"] != 8 or per["aborted"]:
        fail(f"not every request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean run: {nonzero}")
    if counters["qgemm_checks"] != 8 * 8 or \
            counters["embedding_bag_checks"] != 8 * ex.n_tables:
        fail(f"unexpected check counts {counters}")
    if min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                 "quantize_rows")) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    serve_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps)
    details["serve"] = {"requests": per["requests"],
                        "request_ms": serve_ms,
                        "request_ms_median": float(np.median(serve_ms)),
                        "launches": launches, "counters": counters}

    def one_request(seed):
        return engine.run(stream(1, seed), warmup=False).summary()[
            "faults"]["counters"]

    # faults through the engine's FaultInjection, each flipped in place
    # before its step and checked on the leaf afterwards: a transient flip
    # of top.0's packed weight at the second of three requests; a high
    # bit of a table row the request gathers; a persistent top.0 flip,
    # flagged at every later request until reset_state restores it
    from repro_torch.serving import FaultInjection

    def slow(n, seed):            # one request per engine step
        return dlrm_stream(n, tenants={"default": 1.0}, rate_rps=0.01,
                           seed=seed, lookup_batch=m,
                           table_rows=ex.table_rows, n_tables=ex.n_tables)

    def inject_run(reqs, inj, leaf):
        engine.reset_state()
        before = leaf_fingerprint(torch, leaf)
        tel = engine.run(reqs, inject=[inj], warmup=False)
        if inj.persistent:
            engine.reset_state()
        return tel, before, leaf_fingerprint(torch, leaf)

    top0 = params["top"][0]["w_packed"]
    tel, fp0, fp1 = inject_run(slow(3, 11), FaultInjection(
        step=1, victim="top.0", seed=0), top0)
    flips = {"weight": check_injection(tel, 1, [1], fp0, fp1,
                                       "DLRM top.0 flip")}
    req = stream(1, 12)[0]
    bags = req.payload["bags"]

    def reads(idx):
        t, row = divmod(idx // ex.emb_dim, ex.table_rows)
        return row in set(bags[t].reshape(-1).tolist())

    t_seed = injection_seed(torch, tables["table"], "tables.table", reads)
    tel, fp0, fp1 = inject_run([req], FaultInjection(
        step=0, victim="tables", seed=t_seed), tables["table"])
    flips["table"] = check_injection(tel, 0, [0], fp0, fp1,
                                     "DLRM table flip")
    flips["table"]["seed"] = t_seed
    tel, fp0, fp1 = inject_run(slow(4, 13), FaultInjection(
        step=1, victim="top.0", persistent=True, seed=1), top0)
    flips["persistent"] = check_injection(tel, 1, [1, 2, 3], fp0, fp1,
                                          "DLRM persistent top.0 flip")
    engine.reset_state()
    c_clean = one_request(12)
    if c_clean["qgemm_errors"] or c_clean["embedding_bag_errors"]:
        fail("errors after restoring the injected flips")
    flips["restored"] = c_clean
    log(f"FaultInjection on DLRM: {flips['weight']['victim']} flagged at "
        f"step {flips['weight']['detect_step']} only; "
        f"{flips['table']['victim']} (seed {t_seed}, a row the request "
        f"reads) flagged at step {flips['table']['detect_step']}; the "
        f"persistent flip flagged at steps "
        f"{flips['persistent']['flagged_steps']}; every leaf bit-identical "
        f"afterwards (fingerprints); a clean request after: no errors")
    details["flips"] = flips
    details["outputs"] = check_outputs(torch, dev, params, ex, stream(1, 13))

    # ------------------------------ 5. times --------------------------------
    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, Timer,
                                               bound_ms)
    timer = Timer()
    k3_main = k3_inputs[:8]
    req_bag_sets = [torch.from_numpy(r.payload["bags"]).to(dev)
                    for r in stream(20, 21)]

    def seq(fn, cases):
        return lambda: [fn(*c) for c in cases]

    # cycling index sets: each K2 launch gathers fresh rows, cold in L2
    def eb_fn(sets):
        it = itertools.cycle(sets)
        return lambda: abft_eb_cuda(*enc, next(it), tables["rowsums"])

    def eb_plain_fn(sets):
        it = itertools.cycle(sets)
        return lambda: kops.abft_embedding_bag(*enc, next(it),
                                               tables["rowsums"],
                                               use_kernel=False)

    k1_bytes = sum(m * k + k * (n + 1) + 4 * m * n + 4 * m
                   for k, n in shapes)
    k1_ops = sum(2 * m * k * (n + 1) for k, n in shapes)
    k3_bytes = sum(3 * m * k + 8 * m for k, _ in shapes)   # bf16 in
    k3_ops = sum(6 * m * k for k, _ in shapes)
    (k2_bound, k2_by), (k2_sectors, _) = eb_bounds(req_bags, ex.emb_dim)
    # one protected EmbeddingBag call on the card: the card branch of ops
    # (K2 alone) and the protect layer around it (K2 and the count's sum)
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call
    eb_ops = {
        "ops.abft_embedding_bag": device_ops(
            torch, lambda: kops.abft_embedding_bag(*enc, req_bags,
                                                   tables["rowsums"])),
        "protected_call": device_ops(
            torch, lambda: protected_call("embedding_bag", enc4, req_bags,
                                          rule=ResolvedRule()))}
    n_ops = {k: sum(c for _, c in v) for k, v in eb_ops.items()}
    log(f"device operations of one protected EmbeddingBag call: {n_ops} "
        f"({eb_ops})")
    if n_ops["ops.abft_embedding_bag"] != 1 or n_ops["protected_call"] > 2:
        fail(f"a protected EmbeddingBag call ran {n_ops} device operations")
    details["eb_device_ops"] = eb_ops

    def int_mm_cases():
        out = []
        for (a, bp), (k, n) in zip(k1_main, shapes):
            kp, np_ = -(-k // 8) * 8, -(-(n + 1) // 8) * 8
            ap = torch.zeros((32, kp), dtype=torch.int8, device=dev)
            ap[:m, :k] = a
            bq = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
            bq[:k, :n + 1] = bp[:, :n + 1]
            out.append((ap, bq))
        return out

    # the library call computes the padded product; it is a yardstick only,
    # so a refusal of its shape limits is reported, not fatal
    mm_cases = int_mm_cases()
    try:
        library_k1 = timer.ms(seq(torch._int_mm, mm_cases))
    except RuntimeError as e:
        log(f"torch._int_mm refused the padded shapes: {e}")
        library_k1 = None
    # K3 -> K1 over one request's 8 layers (the weights warm: 1.9 MB)
    dlrm_pair = pair_times(
        timer, [(x, quantize_rows_cuda(x)[0], lambda bp=bp: bp)
                for x, (_, bp) in zip(k3_main, k1_main)], 20)
    log(f"DLRM request, K3 -> K1 over 8 layers {dlrm_pair['pair_ms']:.4f} "
        f"ms, K1 alone {dlrm_pair['k1_alone_ms']:.4f}, K3 alone "
        f"{dlrm_pair['k3_ms']:.4f}: K3 exposed "
        f"{dlrm_pair['exposed_ms'] / 8 * 1e3:.3f} us a launch (without "
        f"PDL: pair {dlrm_pair['pair_no_pdl_ms']:.4f}, K1 alone "
        f"{dlrm_pair['k1_alone_no_pdl_ms']:.4f}, exposed "
        f"{dlrm_pair['exposed_no_pdl_ms'] / 8 * 1e3:.3f} us)")
    details["dlrm_k3_k1_pair"] = dlrm_pair
    rows = [
        ("abft_qgemm", "src/repro_torch/csrc/abft_qgemm.cu",
         timer.ms(seq(abft_qgemm_cuda, k1_main)),
         timer.ms(seq(ref.abft_qgemm_ref, k1_main)),
         bound_ms(k1_bytes, k1_ops, INT8_OPS_PER_S), library_k1),
        ("abft_embeddingbag", "src/repro_torch/csrc/abft_embeddingbag.cu",
         timer.ms(eb_fn(req_bag_sets)), timer.ms(eb_plain_fn(req_bag_sets)),
         (k2_bound, k2_by), None),
        ("quantize_rows", "src/repro_torch/csrc/quantize_rows.cu",
         timer.ms(seq(quantize_rows_cuda, [(x,) for x in k3_main])),
         timer.ms(seq(ref.quantize_rows_ref, [(x,) for x in k3_main])),
         bound_ms(k3_bytes, k3_ops, F32_OPS_PER_S), None),
    ]
    per = {"abft_qgemm": "one request: 8 launches, the layer shapes at m=10",
           "abft_embeddingbag": "one request: 1 launch, 26 tables x 10 "
                                "bags x <=16 slots",
           "quantize_rows": "one request: 8 launches, the layer input "
                            "widths at m=10, bf16"}
    kernels = []
    for name, source, ms, plain_ms, (bms, by), lib in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "per": per[name]})
    kernels[2]["exposed_in_k1_pair_ms"] = dlrm_pair["exposed_ms"]
    kernels[1]["sector_bound_ms"] = k2_sectors

    # the larger shapes, for the record (the library call's operand is
    # padded to n + 8 columns outside the timed region)
    b_big = bp_big[:, :1032].contiguous()
    big_bag_sets = [big_bags] + [
        torch.randint(0, ex.table_rows, big_bags.shape, generator=gen,
                      device=dev, dtype=torch.int32) for _ in range(3)]
    k3_tiny = torch.randn((1, 8), generator=gen, device=dev).to(
        torch.bfloat16)
    (big_bound, _), (big_sectors, _) = eb_bounds(big_bags, ex.emb_dim)
    details["large"] = {
        "abft_qgemm m=2048 k=1024 n=1024": {
            "ms": timer.ms(lambda: abft_qgemm_cuda(a_big, bp_big), 10),
            "plain_ms": timer.ms(lambda: ref.abft_qgemm_ref(a_big, bp_big),
                                 10),
            "library_ms": (timer.ms(lambda: torch._int_mm(a_big, b_big), 10)
                           if library_k1 is not None else None),
            "bound": bound_ms(2048 * 1024 + 1024 * 1025 + 4 * 2048 * 1028,
                              2 * 2048 * 1024 * 1025, INT8_OPS_PER_S)},
        # a chain of the smallest K3: what a launch costs with nothing to
        # do, each a programmatic dependent of the last, and without that
        "quantize_rows 1x8 (launch floor)": {
            "ms": timer.ms(lambda: quantize_rows_cuda(k3_tiny), 50),
            "no_pdl_ms": timer.ms(
                lambda: quantize_rows_cuda(k3_tiny, pdl=False), 50)},
        "quantize_rows 2048x1024": {
            "ms": timer.ms(lambda: quantize_rows_cuda(k3_inputs[-1]), 10),
            "plain_ms": timer.ms(
                lambda: ref.quantize_rows_ref(k3_inputs[-1]), 10),
            "bound": bound_ms(5 * 2048 * 1024 + 8 * 2048, 6 * 2048 * 1024,
                              F32_OPS_PER_S)},
        "abft_embeddingbag 26x2048 bags x 100": {
            "ms": timer.ms(eb_fn(big_bag_sets), 4),
            "plain_ms": timer.ms(eb_plain_fn(big_bag_sets), 2),
            "bound": big_bound, "sector_bound_ms": big_sectors},
    }
    details["profile"], dtypes = kernel_input_dtypes(
        lambda: profile_requests(torch, engine, stream(4, 31)))
    details["kernel_input_dtypes"] = dtypes
    if dtypes != {"quantize_rows": [("bfloat16",)], "wkv6_chunked": []}:
        fail(f"K3 was handed {dtypes} on the DLRM path, not its bf16 "
             f"activations uncast")

    # --------------------------- 6-8. RWKV6-1.6B ----------------------------
    from repro_torch.configs import get_arch
    rwkv = rwkv_phases(torch, dev, timer, details, get_arch("rwkv6-1.6b"),
                       (4, 4096))
    # ----------------------- 9. the campaign grids --------------------------
    camp_dir = str(Path(args.out).parent / "campaign") if args.out else None
    campaign = campaign_phase(torch, dev, camp_dir)
    details["campaign"] = campaign
    # ------------------- 10. the thresholds grid (K2) ----------------------
    thresholds = thresholds_phase(torch, dev, camp_dir)
    details["thresholds"] = thresholds
    # ------------- 11. the overhead benchmarks (Fig. 5, Table I) -----------
    overhead = overhead_phase(torch, dev, timer)
    details["overhead"] = overhead
    # ------------------------- 12. the float DLRM --------------------------
    details["float_dlrm"] = float_dlrm = float_dlrm_phase(torch, dev, ex,
                                                          tables)
    kernels[1]["rwkv_token_table"] = rwkv["k2_times"]
    kernels.append(rwkv["k4_row"])
    for r in overhead["rows"]:
        (bms, by) = r.pop("bound")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": overhead["launches"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"], "per": r["per"],
            "baseline_of": {"qgemm_unprotected": "abft_qgemm",
                            "eb_unprotected": "abft_embeddingbag"}[r["name"]],
            "note": "the unprotected instance the overhead benchmarks time; "
                    "not a TPU kernel's port"})
    # each path's counts were set to 0 just before it and read just after
    by_path = {"dlrm": launches, "rwkv6": rwkv["launches"],
               "campaign": campaign["launches"],
               "thresholds": thresholds["launches"],
               "overhead": overhead["launches"],
               "float_dlrm": float_dlrm["launches"]}
    for row in kernels:
        row["launches_by_path"] = {p: counts[row["name"]]
                                   for p, counts in by_path.items()}
    details["kernels"] = kernels
    details["seconds"] = time.perf_counter() - t_start
    log("large shapes: " + json.dumps(details["large"]))
    log(f"serve: request ms median {details['serve']['request_ms_median']:.3f}"
        f" of {serve_ms}")
    log(f"done in {details['seconds']:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(details, indent=2))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
