"""The port's block_ragged probe (``rbg_tpu_torch/bench.py``) against the
reference's (``bench.py``) on the CPU: the same prefill-heavy pack, value
for value, and the plain version on it within 1e-5 of the token-grid
kernel's TPU original (``ragged_paged_attention_pallas_tokengrid`` in
interpret mode) and of the reference's XLA function. On the CPU the probe
times nothing and says so."""

import importlib

import numpy as np
import pytest

import bench as j_bench
from rbg_tpu.ops.pallas.ragged_attention_kernel import (
    ragged_paged_attention_pallas_tokengrid)
from rbg_tpu_torch import bench
from rbg_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention_plain


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def reference_pack():
    """The arguments the reference probe builds, captured at its first call
    of the XLA function (the probe stops there)."""
    # The package re-exports a function under the module's name.
    j_ragged = importlib.import_module("rbg_tpu.ops.ragged_paged_attention")
    seen = {}
    real = j_ragged.ragged_paged_attention_xla

    def capture(*args):
        seen["args"] = args
        raise _Captured

    j_ragged.ragged_paged_attention_xla = capture
    try:
        with pytest.raises(_Captured):
            j_bench.block_ragged_probe()
    finally:
        j_ragged.ragged_paged_attention_xla = real
    return seen["args"], real


def test_probe_pack_equals_the_reference(reference_pack):
    want, _ = reference_pack
    got = bench.block_ragged_pack("cpu")
    assert bench.BLOCK_RAGGED_SPECS == j_bench.BLOCK_RAGGED_SPECS
    assert (bench.BLOCK_RAGGED_REPS, bench.BLOCK_RAGGED_ITERS) == (
        j_bench.BLOCK_RAGGED_REPS, j_bench.BLOCK_RAGGED_ITERS)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_plain_matches_tokengrid_pallas_on_the_pack(reference_pack):
    want, xla = reference_pack
    got = ragged_paged_attention_plain(*bench.block_ragged_pack("cpu")).numpy()
    tokengrid = np.asarray(ragged_paged_attention_pallas_tokengrid(*want,
                                                                   interpret=True))
    np.testing.assert_allclose(got, tokengrid, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla(*want)), rtol=1e-5, atol=1e-5)


def test_probe_on_cpu_is_not_measurable():
    out = bench.block_ragged_probe(device="cpu")
    assert out["measurable"] is False and out["gate"] == "not_measurable"
    assert out["plain_finite"] and out["metric"].endswith("_T179_rows7")
    assert "tokengrid_calls_per_s" not in out
