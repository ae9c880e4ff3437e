"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(:mod:`.ref`) and the dispatch surface over both (:mod:`.ops`).

- K1 ``abft_qgemm.abft_qgemm_cuda`` replaces
  ``repro/kernels/abft_qgemm.py::abft_qgemm_pallas``;
- K2 ``abft_embeddingbag.abft_eb_cuda`` replaces
  ``repro/kernels/abft_embeddingbag.py::abft_eb_pallas``;
- K3 ``quantize_rows.quantize_rows_cuda`` replaces
  ``repro/kernels/quantize_rows.py::quantize_rows_pallas``.

Each wrapper counts its launches in ``<wrapper>.launches``.  The sources
under ``csrc/`` are compiled at first use (:mod:`._build`).
"""
