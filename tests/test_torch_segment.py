"""The port's segmentation against the numpy oracle and the JAX scan.

Segments must be exactly equal (integers) to ``segment_np.segment_oracle``
(which keeps the reference's count-carry quirk) and to
``sylber_tpu.ops.segment.segment_batch``; pooled features agree at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops import segment as jax_segment
from sylber_tpu.ops.segment_np import pool_segment_features, segment_oracle
from sylber_tpu_torch.ops import segment as port


def synthetic_states(rng, L=240, d=64, silence_prob=0.25, noise=0.15,
                     sil_scale=0.05):
    """Syllable plateaus with small noise, separated by low-norm gaps."""
    states = np.zeros((L, d), np.float32)
    i = 0
    while i < L:
        span = min(int(rng.randint(2, 14)), L - i)
        if rng.rand() < silence_prob:
            states[i:i + span] = rng.randn(span, d) * sil_scale
        else:
            proto = rng.randn(d)
            proto = proto / np.linalg.norm(proto) * rng.uniform(4.0, 9.0)
            states[i:i + span] = proto + rng.randn(span, d) * noise
        i += span
    return states


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_batch_equals_oracle_and_jax(seed):
    rng = np.random.RandomState(seed)
    B, L, d = 4, 200, 48
    states = np.stack([synthetic_states(rng, L, d) for _ in range(B)])
    lens = np.array([200, 171, 96, 5])
    valid = np.arange(L)[None, :] < lens[:, None]
    nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.6, 0.95))

    got = port.segment_batch(torch.from_numpy(states), nt, mt,
                             frame_valid=torch.from_numpy(valid))
    want = jax_segment.segment_batch(jnp.asarray(states), nt, mt,
                                     frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(got.num_segments.numpy(), np.asarray(want.num_segments))
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.norms.numpy(), np.asarray(want.norms),
                               rtol=1e-6, atol=1e-6)
    for b in range(B):
        n = int(got.num_segments[b])
        ref = segment_oracle(states[b, :lens[b]], nt, mt)
        assert got.segments[b, :n].numpy().tolist() == ref.tolist()
        if n:
            np.testing.assert_allclose(
                got.features[b, :n].numpy(),
                pool_segment_features(states[b], ref), rtol=1e-5, atol=1e-5)


def test_count_carry_quirk_and_empty_rows():
    """A boundary keeps counting (the next mean is weighted by the carried
    count), and an all-silent row yields no segment."""
    rng = np.random.RandomState(7)
    d = 16
    a, b = rng.randn(d), rng.randn(d)
    a, b = a / np.linalg.norm(a) * 5, b / np.linalg.norm(b) * 5
    row = np.stack([a] * 6 + [b] + [0.7 * a + 0.3 * b] * 5).astype(np.float32)
    states = np.stack([row, np.zeros_like(row)])
    got = port.segment_batch(torch.from_numpy(states), 1.0, 0.8)
    ref = segment_oracle(row, 1.0, 0.8)
    n = int(got.num_segments[0])
    assert got.segments[0, :n].numpy().tolist() == ref.tolist()
    assert int(got.num_segments[1]) == 0
    assert not got.features[1].any()


def test_averaged_target_fill_matches_jax():
    rng = np.random.RandomState(3)
    states = np.stack([synthetic_states(rng, 120, 32) for _ in range(2)])
    res = jax_segment.segment_batch(jnp.asarray(states), 2.0, 0.8)
    want = jax_segment.averaged_target_fill(jnp.asarray(states), res.segments,
                                            res.num_segments)
    got = port.averaged_target_fill(torch.from_numpy(states),
                                    torch.from_numpy(np.array(res.segments)),
                                    torch.from_numpy(np.array(res.num_segments)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
