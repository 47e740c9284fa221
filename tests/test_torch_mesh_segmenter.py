"""``Segmenter(mesh=...)``: data-parallel inference over replicas in one
process (``sylber_tpu_torch/parallel/mesh.py::make_mesh(dp, devices=...)``).

Two replicas on the CPU against the plain ``Segmenter`` with the same
weights (the tiny encoder of ``tests/multidevice/test_dp_tp.py``, fp32
"highest"), on a batch of 3 utterances of 2-5 s (the 5 s bucket) and one of
3 utterances of 12-20 s: segments identical and hidden states and segment
features within 1e-6, through ``__call__``/``process`` and through
``process_async`` (every replica's work enqueued before ``finalize``);
long-form over 60 s (10 s windows, 4 a batch) with the int16 and float32
transfers, with and without the hidden track: segments identical and
features within 1e-6 (with a mesh the int16 transfer without the hidden
track takes the non-resident path, as in JAX's ``longform.py:140``; the
plain ``Segmenter`` takes the resident one there, so that case is held
against a one-replica mesh, which takes the same path). The batch buckets keep the multiples of dp. Then JAX's
``test_segmenter_dp_inference_matches_single`` on the same weights: JAX's
``Segmenter`` over a dp=4 mesh of simulated CPU devices against the port's
two replicas, segments identical, hidden states at JAX's atol 2e-4 / rtol
1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict
from sylber_tpu_torch.longform import LongFormSegmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.parallel.mesh import make_mesh

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            precision="highest")
KW = dict(norm_threshold=1.0, merge_threshold=0.9)


@pytest.fixture(scope="module")
def segmenters():
    torch.set_num_threads(2)
    plain = Segmenter(hubert_config=HubertConfig(**TINY), device="cpu", **KW)
    params = jax_params_from_state_dict(plain.model.state_dict())
    dp = Segmenter(hubert_config=HubertConfig(**TINY), params=params,
                   mesh=make_mesh(2, devices=["cpu", "cpu"]), **KW)
    return plain, dp, params


def _wavs(seed, lo, hi, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(int(rng.uniform(lo, hi) * 16000)).astype(np.float32) for _ in range(n)]


def _same(a, b):
    for x, y in zip(a, b):
        assert x["segments"].tolist() == y["segments"].tolist()
        np.testing.assert_allclose(x["segment_features"], y["segment_features"], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(x["hidden_states"], y["hidden_states"], atol=1e-6, rtol=0)
        assert len(x["segments"]) > 2


@pytest.mark.parametrize("bucket", [(2.0, 5.0), (12.0, 20.0)], ids=["5s", "12-20s"])
def test_replicas_give_the_plain_segmenters_results(segmenters, bucket):
    plain, dp, _ = segmenters
    wavs = _wavs(1, *bucket)
    _same(plain(wav=wavs, in_second=False), dp(wav=wavs, in_second=False))
    pending = dp.process_async(wavs, in_second=False)   # both replicas enqueued
    _same(plain.process(wavs, in_second=False), pending())


def test_longform_over_replicas(segmenters):
    plain, dp, params = segmenters
    one = Segmenter(hubert_config=HubertConfig(**TINY), params=params,
                    mesh=make_mesh(1, devices=["cpu"]), **KW)
    wav = _wavs(2, 60.0, 60.5, n=1)[0]
    for transfer in ("int16", "float32"):
        lf = dict(chunk_seconds=10.0, overlap_seconds=2.0, batch_windows=4, transfer=transfer)
        for hidden in (True, False):
            ref = one if (transfer, hidden) == ("int16", False) else plain
            a = LongFormSegmenter(ref, **lf)(wav=wav, in_second=False, return_hidden=hidden)
            b = LongFormSegmenter(dp, **lf)(wav=wav, in_second=False, return_hidden=hidden)
            assert a["segments"].tolist() == b["segments"].tolist() and len(a["segments"]) > 10
            np.testing.assert_allclose(a["segment_features"], b["segment_features"], atol=1e-6,
                                       rtol=0)


def test_batch_buckets_keep_the_multiples_of_dp(segmenters):
    _, dp, params = segmenters
    assert dp.batch_buckets == (2, 4, 8, 16, 32)
    assert dp.mesh.shape == {"dp": 2, "mp": 1}
    three = Segmenter(hubert_config=HubertConfig(**TINY), params=params,
                      mesh=make_mesh(devices=["cpu"] * 3), **KW)
    assert three.batch_buckets == (3,)
    assert len(three(wav=_wavs(3, 1.0, 2.0, n=4), in_second=False)) == 4  # split in batches of 3


def test_matches_jax_dp_segmenter_on_the_same_weights(segmenters):
    _, dp, params = segmenters
    mesh = jax_make_mesh(dp=4, mp=1)
    rng = np.random.RandomState(5)
    wavs = [rng.randn(n).astype(np.float32) for n in (9000, 12000, 8000)]
    jseg = JaxSegmenter(hubert_config=JaxConfig(**TINY), params=params, mesh=mesh, **KW)
    with jax.set_mesh(mesh):
        want = jseg(wav=wavs, in_second=False)
    got = dp(wav=wavs, in_second=False)
    for a, b in zip(want, got):
        assert a["segments"].tolist() == b["segments"].tolist()
        np.testing.assert_allclose(a["hidden_states"], b["hidden_states"], atol=2e-4, rtol=1e-3)
