"""PyTorch/CUDA port of the ABFT soft-error detection system (arXiv
2103.00130) for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports neither JAX nor ``repro``.  The first
slice is the paper's own main path, int8 DLRM serving with both protected
operators; the second is int8 RWKV6 chat serving with ABFT on every
projection and the token embedding:

- :mod:`repro_torch.core`     — Algorithm 1/2 checksum algebra, reports
- :mod:`repro_torch.kernels`  — the hand-written CUDA kernels (K1-K4),
  their plain PyTorch versions and the dispatch over both
- :mod:`repro_torch.protect`  — plans, adapters, the protected-call runtime
- :mod:`repro_torch.layers`, :mod:`repro_torch.models` — the int8 DLRM
  and RWKV6
- :mod:`repro_torch.serving`, :mod:`repro_torch.launch.serve` — serving,
  with weight-fault injection
- :mod:`repro_torch.campaign` — the main-path resilience campaign
- :mod:`repro_torch.optim`, :mod:`repro_torch.runtime`,
  :mod:`repro_torch.checkpoint`, :mod:`repro_torch.launch.train` —
  training under faults: AdamW, the int8 error-feedback gradient
  reduction checked mod 8191, the detect->act loop, checksummed
  checkpoints

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
