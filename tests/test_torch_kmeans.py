"""The port's mini-batch k-means (``sylber_tpu_torch/flow/kmeans.py``)
against ``sylber_tpu/flow/kmeans.py`` on the CPU, fp32.

- ``_assign`` equal to JAX's, ``_minibatch_update`` within rtol 1e-6.
- ``fit_kmeans`` equal to JAX's (centroids within 1e-5, inertia rtol 1e-5)
  when the seeding is JAX's own ``_kmeanspp_init`` output: the host
  ``RandomState`` calls (seed pool, subsample, permutations, re-seeding) are
  JAX's, in JAX's order.
- The seeding's plain version (the kernel's on CPU tensors): on a pool of k
  distinct points each repeated it returns JAX's set of centers exactly
  (both must take every distinct point once); its second draw over 3,000
  seeds follows d^2 / sum d^2 (chi-square, p above 1e-3); center 0 is
  uniform over the rows.
- The kernel's wrapper raises a ``ValueError`` before the launch, naming
  the limit, for a shape the kernel cannot take (past ``MAX_WIDTH``, or
  more rows than a block's weights hold in shared memory), and takes the
  widths JAX takes below that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sylber_tpu.flow import kmeans as jkm
from sylber_tpu_torch.flow import kmeans as tkm


def _points(n, d, seed=0, clusters=6):
    rng = np.random.RandomState(seed)
    means = rng.randn(clusters, d) * 3
    return (means[rng.randint(0, clusters, n)] + rng.randn(n, d)).astype(np.float32)


def test_assign_equals_jax():
    x = _points(500, 24, seed=1)
    c = _points(37, 24, seed=2)
    want = np.asarray(jkm._assign(jnp.asarray(x), jnp.asarray(c)))
    got = tkm._assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_minibatch_update_matches_jax():
    x = _points(700, 16, seed=3)
    c = _points(40, 16, seed=4)  # some clusters get no point of the batch
    counts = np.random.RandomState(5).randint(0, 9, 40).astype(np.float32)
    wc, wn, wi = jkm._minibatch_update(jnp.asarray(c), jnp.asarray(counts), jnp.asarray(x))
    gc, gn, gi = tkm._minibatch_update(torch.from_numpy(c), torch.from_numpy(counts),
                                       torch.from_numpy(x))
    assert (np.asarray(wn) == counts).any()  # an empty cluster keeps its centroid
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(gi), float(wi), rtol=1e-6)


@pytest.mark.parametrize("normalize,n,k,batch", [(False, 3000, 24, 700), (True, 2000, 40, 2000)])
def test_fit_kmeans_matches_jax_given_its_seeding(monkeypatch, normalize, n, k, batch):
    x = _points(n, 12, seed=n, clusters=30)

    def jax_seeding(seed, pool, kk):
        out = jkm._kmeanspp_init(jax.random.PRNGKey(seed), jnp.asarray(pool.numpy()), kk)
        return torch.from_numpy(np.array(out))

    monkeypatch.setattr(tkm, "_kmeanspp_init", jax_seeding)
    want_c, want_i = jkm.fit_kmeans(x, k, batch_size=batch, n_epochs=4, seed=3,
                                    normalize=normalize)
    got_c, got_i = tkm.fit_kmeans(x, k, batch_size=batch, n_epochs=4, seed=3,
                                  normalize=normalize, device="cpu")
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-5)


def test_fit_kmeans_runs_its_own_seeding():
    x = _points(1200, 8, seed=9, clusters=10)
    c, inertia = tkm.fit_kmeans(x, 10, batch_size=400, n_epochs=3, seed=1, device="cpu")
    assert c.shape == (10, 8) and np.isfinite(c).all() and 0 < inertia < 20
    with pytest.raises(ValueError, match="clusters"):
        tkm.fit_kmeans(x[:5], 10, device="cpu")


@pytest.mark.parametrize("k,copies,d", [(16, 8, 8), (24, 3, 24)])
def test_seeding_takes_every_distinct_point_once_as_jax_does(k, copies, d):
    rng = np.random.RandomState(k)
    pts = rng.randn(k, d).astype(np.float32)
    pool = pts[rng.permutation(np.repeat(np.arange(k), copies))]
    want = np.asarray(jkm._kmeanspp_init(jax.random.PRNGKey(0), jnp.asarray(pool), k))
    for seed in range(3):
        got = tkm._kmeanspp_init(seed, torch.from_numpy(pool), k).numpy()
        as_set = lambda a: sorted(map(tuple, a.tolist()))  # noqa: E731
        assert as_set(got) == as_set(want) == as_set(pts)


def test_seeding_draws_by_squared_distance():
    """Center 1 given center 0 is drawn with probability d^2 / sum d^2 (the
    law of JAX's categorical over log d^2): 3,000 seedings of 2 centers from
    an 8-point pool, against the exact mixture over center 0 (uniform)."""
    pool = np.array([[0, 0], [1, 0], [0, 2], [3, 1], [-2, -1], [0.5, 0.5], [4, 4], [-1, 3]],
                    np.float32)
    n, seeds = len(pool), 3000
    d2 = ((pool[:, None] - pool[None]) ** 2).sum(-1).astype(np.float64)
    w = np.maximum(d2, 1e-30)
    expected = (w / w.sum(1, keepdims=True)).mean(0) * seeds
    first, second = np.zeros(n), np.zeros(n)
    x = torch.from_numpy(pool)
    for seed in range(seeds):
        _, rows = tkm.kmeanspp_plain(x, tkm.seeding_uniforms(seed, 2))
        first[int(rows[0])] += 1
        second[int(rows[1])] += 1
    p_second = stats.chisquare(second, expected).pvalue
    p_first = stats.chisquare(first, np.full(n, seeds / n)).pvalue
    assert p_second > 1e-3 and p_first > 1e-3, (p_second, p_first)


@pytest.mark.parametrize("n,d,match", [
    (4, tkm.MAX_WIDTH + 1, "a width of 536870913 is past the kernel's 536870912"),
    (132 * 19236 + 1, 8, "19237 a block on 132 blocks, whose weights need 232480 bytes"),
], ids=["width", "rows"])
def test_wrapper_refuses_before_the_launch(monkeypatch, n, d, match):
    """``kmeanspp`` on a device tensor (a ``meta`` tensor stands in for the
    card's: no memory, no kernel) with an H100's 132 SMs and 232,448 bytes
    of shared memory a block: a ``ValueError`` that says why, raised before
    the library is loaded; the widths of the card's checks pass."""
    import types

    def no_launch():
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(tkm, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tkm, "lib", no_launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(
        multi_processor_count=132, shared_memory_per_block_optin=232448))
    x = torch.empty(n, d, device="meta")
    with pytest.raises(ValueError, match="kmeanspp: the seeding kernel refuses x .*" + match):
        tkm.kmeanspp(x, torch.rand(4, dtype=torch.float64))
    for shape in ((512, 4100), (64, 60000), (65536, 768), (132 * 19236, 8)):
        assert tkm.seeding_refusal(*shape, 132, 232448) is None
