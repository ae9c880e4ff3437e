"""PyTorch/CUDA port of the ABFT soft-error detection system (arXiv
2103.00130) for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports neither JAX nor ``repro``.  The first
slice is the paper's own main path, int8 DLRM serving with both protected
operators:

- :mod:`repro_torch.core`     — Algorithm 1/2 checksum algebra, reports
- :mod:`repro_torch.kernels`  — the hand-written CUDA kernels (K1-K3),
  their plain PyTorch versions and the dispatch over both
- :mod:`repro_torch.protect`  — plans, adapters, the protected-call runtime
- :mod:`repro_torch.layers`, :mod:`repro_torch.models` — the int8 DLRM
- :mod:`repro_torch.serving`, :mod:`repro_torch.launch.serve` — serving

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
