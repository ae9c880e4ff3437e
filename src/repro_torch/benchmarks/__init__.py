"""The paper's overhead benchmarks on the card (the port's counterparts of
the root ``benchmarks/`` modules of the JAX package):

- :mod:`~repro_torch.benchmarks.gemm_overhead` — Fig. 5, the ABFT int8
  GEMM (K1) against its unprotected instance over the 28 DLRM shapes;
- :mod:`~repro_torch.benchmarks.eb_overhead` — Table I / Fig. 6, the ABFT
  EmbeddingBag (K2) against its unprotected instance, 4M-row tables.

Run ``python -m repro_torch.benchmarks.run [--quick] [--only NAME]
[--device cpu]``.  On the card every time is device time by CUDA events;
on the CPU the modules run the plain versions, only to exercise their
arithmetic and columns (host times, no device metric).
"""
