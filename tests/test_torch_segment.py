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
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


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


UNEVEN_ROWS = {
    # name: per-row (silence probability, plateau noise): very different nmid per row
    "one-busy-row": [(0.0, 0.15), (1.0, 0.15), (0.25, 0.15), (1.0, 0.15)],
    "boundary-every-frame": [(0.0, 8.0), (0.25, 0.15), (1.0, 0.15), (0.0, 0.15)],
    "all-silent-but-one": [(1.0, 0.15), (1.0, 0.15), (0.0, 0.3), (1.0, 0.15)],
}


@pytest.mark.parametrize("name", list(UNEVEN_ROWS))
def test_rows_with_uneven_mid_boundaries_equal_per_row_results(name):
    """A batch whose rows have very different numbers of mid boundaries gives
    what each row gives alone, and what the JAX ``segment_batch`` gives: the
    refinement of a row loops over that row's own boundaries (the batch-wide
    bound of the vectorised loop changes nothing), which is what the CUDA
    kernel relies on when it gives every row its own loop."""
    rng = np.random.RandomState(len(name))
    L, d, nt, mt = 160, 32, 2.6, 0.8
    states = np.stack([synthetic_states(rng, L, d, silence_prob=p, noise=s)
                       for p, s in UNEVEN_ROWS[name]])
    x = torch.from_numpy(states)
    got = port.segment_batch(x, nt, mt)
    voiced = port.frame_norms(x) >= nt
    nmid = port.segment_pass1(x, voiced, mt).nmid.tolist()
    assert max(nmid) >= 10 * max(min(nmid), 1) or min(nmid) == 0, nmid

    want = jax_segment.segment_batch(jnp.asarray(states), nt, mt)
    np.testing.assert_array_equal(got.num_segments.numpy(), np.asarray(want.num_segments))
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    for b in range(len(states)):
        alone = port.segment_batch(x[b:b + 1], nt, mt)
        assert int(alone.num_segments[0]) == int(got.num_segments[b])
        np.testing.assert_array_equal(alone.segments[0].numpy(), got.segments[b].numpy())
        np.testing.assert_allclose(alone.features[0].numpy(), got.features[b].numpy(),
                                   rtol=1e-5, atol=1e-5)
        oracle = segment_oracle(states[b], nt, mt)
        assert got.segments[b, :int(got.num_segments[b])].numpy().tolist() == oracle.tolist()


@pytest.mark.parametrize("mt", [0.7, 0.812345678901234, 2.0 / 3.0])
def test_segment_batch_takes_the_merge_threshold_from_device_memory(mt):
    """A 0-d float32 tensor as the merge threshold (the trainer's, read by
    the kernels from memory) gives the bits of the host number: both are
    compared in float32, including thresholds that float32 does not hold
    exactly. Held to JAX's ``segment_batch`` at the number too."""
    rng = np.random.RandomState(7)
    B, L, d = 3, 160, 48
    states = torch.from_numpy(np.stack([synthetic_states(rng, L, d) for _ in range(B)]))
    host = port.segment_batch(states, 2.0, mt)
    dev = port.segment_batch(states, 2.0, torch.tensor(mt, dtype=torch.float32))
    for field in ("segments", "num_segments", "features", "norms"):
        assert torch.equal(getattr(host, field), getattr(dev, field)), field
    want = jax_segment.segment_batch(jnp.asarray(states.numpy()), 2.0, mt)
    np.testing.assert_array_equal(dev.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_array_equal(dev.num_segments.numpy(), np.asarray(want.num_segments))
