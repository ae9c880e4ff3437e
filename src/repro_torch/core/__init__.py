"""The paper's contribution in PyTorch: ABFT for low-precision ops.

- :mod:`repro_torch.core.abft_gemm`      — Algorithm 1 (quantized GEMM)
- :mod:`repro_torch.core.abft_embedding` — Algorithm 2 (quantized EmbeddingBag)
- :mod:`repro_torch.core.policy`         — FaultReport + detect->act policies
- :mod:`repro_torch.core.abft_float`     — float ABFT for bf16/f32 GEMMs
  (beyond the paper)
- :mod:`repro_torch.core.inject`         — the fault models (bit flips,
  random values, bit bands) and the victim choice over parameter trees

The KV-cache and checksum modules of ``repro.core`` wait for a later
slice (ROADMAP A4).
"""
from repro_torch.core.abft_gemm import (
    LANE,
    MOD,
    AbftGemmOut,
    abft_qgemm,
    abft_qgemm_packed,
    abft_qgemm_unfused,
    column_check,
    correct_single_error,
    correct_weight_flip,
    detect_prob_b_bitflip,
    detect_prob_b_random,
    detect_prob_c_random,
    encode_activation_checksum,
    encode_weight_checksum,
    encode_weight_colsum,
    int_matmul,
    pack_encoded_b,
    verify_rows,
    wrap_i32,
)
from repro_torch.core.abft_embedding import (
    EB_REL_BOUND,
    AbftEbOut,
    abft_embedding_bag,
    eb_overhead_model,
    embedding_bag,
    table_rowsums,
    verify_bags,
)
from repro_torch.core.abft_float import (
    FloatAbftOut,
    abft_gemm_f32,
    encode_weight_f32,
)
from repro_torch.core.policy import (
    FaultAbort,
    FaultReport,
    empty_report,
    merge_reports,
    op_report,
)

__all__ = [
    "MOD", "LANE", "AbftGemmOut",
    "encode_weight_checksum", "encode_activation_checksum",
    "abft_qgemm", "abft_qgemm_packed", "abft_qgemm_unfused",
    "pack_encoded_b", "verify_rows", "correct_single_error",
    "encode_weight_colsum", "correct_weight_flip", "column_check",
    "int_matmul", "wrap_i32",
    "detect_prob_b_bitflip", "detect_prob_b_random", "detect_prob_c_random",
    "EB_REL_BOUND", "AbftEbOut", "table_rowsums", "embedding_bag",
    "abft_embedding_bag", "verify_bags", "eb_overhead_model",
    "FloatAbftOut", "abft_gemm_f32", "encode_weight_f32",
    "FaultAbort", "FaultReport", "op_report", "merge_reports",
    "empty_report",
]
