"""rbg_tpu_torch's sampler against rbg_tpu's, fed the SAME Gumbel noise:
JAX's own ``gumbel(step_keys(row_keys(...)))`` goes into the port's
``sample_from_noise``, so every sampled token must match, and logprobs
agree within float32 rounding. Also pins the port's own noise rule: a pure
function of (row key, position)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.engine.sampler import row_keys as j_row_keys, sample as j_sample, step_keys
from rbg_tpu_torch.engine.sampler import (gumbel_noise, row_keys, sample,
                                          sample_from_noise)

B, V = 6, 256


def _case(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    seeds = [11, None, 5, None, 7, 3]
    keys = step_keys(j_row_keys(seeds, jax.random.key(1), list(range(B))),
                     jnp.arange(B, dtype=jnp.int32) + 20)
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
    return rng, logits, keys, noise


KNOBS = {
    "temperature": dict(temps=[0.0, 0.7, 1.0, 1.5, 0.3, 2.0]),
    "top_k": dict(temps=[1.0] * B, top_k=[0, 1, 5, 20, 256, 3]),
    "top_p": dict(temps=[1.0] * B, top_p=[1.0, 0.9, 0.5, 0.1, 0.99, 0.7]),
    "min_p": dict(temps=[1.0] * B, min_p=[0.0, 0.05, 0.2, 0.5, 0.01, 0.9]),
    "mixed": dict(temps=[0.0, 0.8, 1.2, 0.5, 1.0, 0.9], top_k=[0, 10, 0, 4, 50, 0],
                  top_p=[1.0, 0.8, 0.95, 1.0, 0.6, 1.0],
                  min_p=[0.0, 0.0, 0.1, 0.0, 0.0, 0.3]),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("penalties", [False, True])
def test_sample_matches_jax_on_jax_noise(knob, penalties):
    rng, logits, keys, noise = _case(sorted(KNOBS).index(knob))
    kn = KNOBS[knob]
    temps = np.asarray(kn["temps"], np.float32)
    ks = np.asarray(kn.get("top_k", [0] * B), np.int32)
    tps = np.asarray(kn.get("top_p", [1.0] * B), np.float32)
    mps = np.asarray(kn.get("min_p", [0.0] * B), np.float32)
    pen = {}
    if penalties:
        pen = dict(prompt_mask=rng.rand(B, V) < 0.1,
                   out_counts=rng.poisson(0.3, (B, V)).astype(np.int32),
                   rep=np.asarray([1.0, 1.3, 0.8, 1.1, 1.0, 2.0], np.float32),
                   pres=np.asarray([0.0, 0.5, 0.0, 1.0, 0.2, 0.0], np.float32),
                   freq=np.asarray([0.0, 0.0, 0.3, 0.1, 0.2, 1.0], np.float32))
    jt, jl = j_sample(jnp.asarray(logits), keys, *map(jnp.asarray, (temps, ks, tps, mps)),
                      want_logprobs=True,
                      **{k: jnp.asarray(v) for k, v in pen.items()})
    t = torch.from_numpy
    tt, tl = sample_from_noise(t(logits), t(noise), *map(t, (temps, ks, tps, mps)),
                               want_logprobs=True,
                               **{k: t(v) for k, v in pen.items()})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_greedy_ties_take_the_first_index_and_skip_noise():
    logits = torch.zeros(2, 8)
    logits[0, [2, 5]] = 1.0
    logits[1, [7, 1]] = 2.0
    z = torch.zeros(2)
    toks, _ = sample_from_noise(logits, None, z, z.long(), z + 1, z)
    assert toks.tolist() == [2, 1]
    toks, _ = sample(logits, torch.zeros(2, dtype=torch.int64), torch.zeros(2),
                     z, z.long(), z + 1, z, any_sampled=False)
    assert toks.tolist() == [2, 1]


def test_noise_is_a_pure_function_of_key_and_position():
    keys = row_keys([7, None, None], 1, [0, 4, 5], "cpu")
    assert keys[0] == 7 and keys[1] != keys[2]
    pos = torch.tensor([3, 3, 3])
    a = gumbel_noise(keys, pos, 1000)
    assert torch.equal(a, gumbel_noise(keys, pos, 1000))
    b = gumbel_noise(keys, pos + 1, 1000)
    assert not torch.equal(a, b)
    assert not torch.equal(a[1], a[2])
    # Gumbel(0, 1): mean 0.5772, variance pi^2/6.
    g = gumbel_noise(torch.arange(64), torch.zeros(64, dtype=torch.int64), 4096)
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
