"""The port's dry run (``repro_torch.launch.dryrun``) held against the
JAX package's on full-width Llama-3.2-1B's training cell (train_4k on
the (16, 16) mesh); ``tests/test_torch_dryrun_serving.py`` holds its
prefill and decode cells.

The JAX record comes from the unchanged ``repro.launch.dryrun.run_cell``
in a subprocess on Auto mesh axes (``tests/torch_dryrun_reference.py``,
ROADMAP §C18).  Compared: the parameter counts, MODEL_FLOPS and the
per-device argument bytes exactly (the same state, placed by the same
rules); the per-device flops within :data:`FLOPS_TOL` (GSPMD's and
DTensor's partitions of the same program, eager ops against XLA's
fusions); JAX's record keys.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_reference import (FLOPS_TOL, check_against_jax,  # noqa: E402
                                    jax_records)

from repro_torch.launch import dryrun  # noqa: E402


def test_train_cell_matches_jax(tmp_path, record_property):
    ref, = jax_records([["llama3.2-1b", "train_4k", False]])
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", False, str(tmp_path))
    ratio = check_against_jax(rec, ref, record_property)
    assert abs(ratio - 1.0) <= FLOPS_TOL, ratio
    # the training state a device holds: its FSDP x TP shards
    mem = rec["memory_per_device"]
    assert mem["breakdown"]["params"] + mem["breakdown"]["optimizer"] \
        + mem["breakdown"]["step"] + mem["breakdown"]["batch"] \
        == mem["argument_bytes"]
    assert (tmp_path / "llama3.2-1b__train_4k__pod16x16.json").exists()
    assert not torch.distributed.is_initialized()
