"""The port's dry run held against the JAX package's on full-width
Llama-3.2-1B's serving cells (prefill_32k and decode_32k on the (16, 16)
mesh), as ``tests/test_torch_dryrun.py`` holds its training cell: the
parameter counts, MODEL_FLOPS and the argument bytes exactly, the
prefill's flops within that file's tolerance.  Decode's flops ratio,
bytes, collectives and temporaries are recorded (junit properties), not
gated: its step is small beside the collectives either partition picks.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_reference import (FLOPS_TOL, check_against_jax,  # noqa: E402
                                    jax_records)

from repro_torch.launch import dryrun  # noqa: E402


@pytest.fixture(scope="module")
def refs():
    recs = jax_records([["llama3.2-1b", s, False]
                        for s in ("prefill_32k", "decode_32k")])
    return {r["shape"]: r for r in recs}


def test_prefill_cell_matches_jax(refs, tmp_path, record_property):
    rec = dryrun.run_cell("llama3.2-1b", "prefill_32k", False,
                          str(tmp_path))
    ratio = check_against_jax(rec, refs["prefill_32k"], record_property)
    assert abs(ratio - 1.0) <= FLOPS_TOL, ratio


def test_decode_cell_matches_jax(refs, tmp_path, record_property):
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False, str(tmp_path))
    check_against_jax(rec, refs["decode_32k"], record_property)
    mem, ref = rec["memory_per_device"], refs["decode_32k"]
    record_property("temp_bytes", mem["temp_bytes"])
    record_property("jax_temp_bytes", ref["memory_per_device"]["temp_bytes"])
    record_property("collectives", rec["cost_per_device"]["collectives"])
    # the int8 weights and the bf16 KV cache a device holds
    assert mem["breakdown"]["params"] + mem["breakdown"]["cache"] \
        + mem["breakdown"]["batch"] == mem["argument_bytes"]
    assert not torch.distributed.is_initialized()
