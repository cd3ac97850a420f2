"""The port's sampler (``core/sampling``) and sampled ``generate`` against the
JAX package.

Masks are deterministic and must be identical: the port's ``top_p_filter``
against the JAX one, ties included.  Draws come from different RNGs in the
two frameworks, so they are held to the JAX nucleus and, over 40,000 draws
from a fixed ``torch.Generator``, to the filtered softmax: every token's
frequency within 5 binomial standard deviations (plus one count) of its
probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.core import sampling as jsampling

from modelcompose_tpu_torch.core import sampling

LOWEST = np.finfo(np.float32).min


def _logits(seed, rows=6, vocab=257, ties=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, vocab)) * 3).astype(np.float32)
    if ties:  # few distinct values: long runs of equal logits
        x = np.round(x / 2).astype(np.float32)
    return x


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_p", [0.1, 0.7, 0.95, 1.0])
def test_top_p_filter_matches_jax(top_p, ties):
    x = _logits(int(top_p * 100), ties=ties)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(x),
                                             jnp.float32(top_p)))
    got = sampling.top_p_filter(torch.from_numpy(x), top_p).numpy()
    np.testing.assert_array_equal(got == LOWEST, want == LOWEST)
    np.testing.assert_array_equal(got, want)
    if top_p == 1.0:
        assert not (got == LOWEST).any()
    else:
        assert (got == LOWEST).any(axis=-1).all()


def test_top_p_filter_per_row_matches_jax():
    x = _logits(3, rows=4, ties=True)
    p = np.array([0.1, 0.5, 0.9, 1.0], np.float32)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(x), jnp.asarray(p)))
    got = sampling.top_p_filter(torch.from_numpy(x),
                                torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_rows_bit_identical_to_argmax():
    x = _logits(4, rows=5)
    temps = torch.tensor([0.0, 1e-5, 1e-3, 0.7, 1.3])
    gen = torch.Generator().manual_seed(0)
    toks = sampling.sample_step(gen, torch.from_numpy(x), temps,
                                torch.full((5,), 0.7))
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks[:3].numpy(), x[:3].argmax(-1))
    jtoks = np.asarray(jsampling.sample_step(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temps.numpy()),
        jnp.full(5, 0.7, jnp.float32)))
    np.testing.assert_array_equal(toks[:3].numpy(), jtoks[:3])


@pytest.mark.parametrize("temperature,top_p", [(1.0, 0.9), (0.7, 0.5),
                                               (1.3, 1.0)])
def test_sampled_frequencies_match_the_filtered_softmax(temperature, top_p):
    """40,000 draws of one row: never outside the JAX nucleus, and each
    token's count within 5 sigma (+1) of n * softmax(filtered)."""
    n = 40_000
    row = _logits(5, rows=1, vocab=40)[0] / 2
    jfiltered = np.asarray(jsampling.top_p_filter(
        jnp.asarray(row / temperature), jnp.float32(top_p)), np.float64)
    nucleus = jfiltered > LOWEST
    probs = np.where(nucleus, np.exp(jfiltered - jfiltered.max()), 0.0)
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(1)
    toks = sampling.sample_logits(
        gen, torch.from_numpy(np.tile(row, (n, 1))),
        torch.full((n,), temperature), torch.full((n,), top_p)).numpy()
    assert nucleus[toks].all()
    counts = np.bincount(toks, minlength=row.size)
    bound = 5 * np.sqrt(n * probs * (1 - probs)) + 1
    assert (np.abs(counts - n * probs) <= bound).all(), (counts, n * probs)
    assert (counts > 0).sum() == nucleus.sum() > 1


def test_categorical_draws_follow_the_generator():
    x = torch.from_numpy(_logits(6, rows=8))
    a = sampling.categorical(torch.Generator().manual_seed(3), x)
    b = sampling.categorical(torch.Generator().manual_seed(3), x)
    c = sampling.categorical(torch.Generator().manual_seed(4), x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_entropy_seed_is_a_u32():
    assert 0 <= sampling.entropy_seed() < 2 ** 32
