"""The port's ``StreamingSegmenter``, k-means quantizers and ``SylberTokenizer``
against the JAX package, on the trained ``mini_ckpt.npz`` in fp32 parity mode.

- Streaming: the same pushes (0.05-0.4 s chunks, rng seed 1) into both
  streaming segmenters (window 4 s, hop 1 s, guard 0.5 s) commit identical
  lists, each exactly once and in order.
- Tokens: on the same segment features, ``KMQuantizer`` (the 256- and
  1024-unit mini codebooks, with and without normalisation) and
  ``ResidualKMQuantizer`` give the JAX package's token ids; a differing id
  counts only as a tie, when its two smallest distances (float64) lie
  within 1e-6 relative of each other. ``decode`` is bit-identical,
  durations equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.flow.quantizer import KMQuantizer as JaxKM
from sylber_tpu.flow.quantizer import ResidualKMQuantizer as JaxResidualKM
from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu.streaming import StreamingSegmenter as JaxStreaming
from sylber_tpu.tokenizer import SylberTokenizer as JaxTokenizer
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.quantizer import KMQuantizer, ResidualKMQuantizer, load_km_quantizer
from sylber_tpu_torch.streaming import StreamingSegmenter
from sylber_tpu_torch.tokenizer import SylberTokenizer

FIXTURES = Path(__file__).parent / "fixtures"
TIE_RTOL = 1e-6


def _utterance(seed, seconds):
    wav, _ = synth_utterance(np.random.RandomState(seed), int(seconds * 16000))
    return ((wav - wav.mean()) / (wav.std(ddof=1) + 1e-12)).astype(np.float32)


@pytest.fixture(scope="module")
def mini():
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    kw = dict(norm_threshold=meta["norm_threshold"], merge_threshold=meta["merge_threshold"])
    jax_seg = JaxSegmenter(params=load_params_npz(str(FIXTURES / "mini_ckpt.npz")),
                           hubert_config=JaxConfig(**hub), **kw)
    port = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"),
                     hubert_config=HubertConfig(**hub), device="cpu", **kw)
    return jax_seg, port


def _stream(cls, seg, wav):
    stream = cls(seg, window_seconds=4.0, hop_seconds=1.0, commit_guard_seconds=0.5)
    rng = np.random.RandomState(1)
    committed, pos = [], 0
    while pos < len(wav):  # chunk sizes as a microphone delivers them
        n = int(rng.uniform(0.05, 0.4) * 16000)
        committed.extend(stream.push(wav[pos: pos + n], in_second=False))
        pos += n
    return committed + stream.flush(in_second=False)


def test_streaming_commits_match_jax(mini):
    jax_seg, port = mini
    wav = _utterance(2718, 16.0)
    want = _stream(JaxStreaming, jax_seg, wav)
    got = _stream(StreamingSegmenter, port, wav)
    assert got == want
    arr = np.asarray(got, np.int64).reshape(-1, 2)
    assert len(arr) > 20
    assert (arr[:, 1] > arr[:, 0]).all()
    assert (arr[1:, 0] >= arr[:-1, 1]).all()  # exactly once, in order
    assert arr[-1, 1] <= len(wav) // 320


@pytest.fixture(scope="module")
def features(mini):
    """Segment features of three utterances, from the port's segmenter."""
    _, port = mini
    outs = port.process([_utterance(s, 6.0) for s in (5, 6, 7)], in_second=False,
                        return_hidden=False)
    feats = np.concatenate([o["segment_features"] for o in outs])
    assert len(feats) > 40
    return feats


def _assert_same_or_tied(got, want, x, centroids, normalize):
    """Token ids equal, except where the two nearest centroids of x are a tie.
    ``centroids`` is a pair for residual ids: the second stage is held on the
    rows whose first ids agree, on the residual of the unnormalised x."""
    if isinstance(centroids, tuple):
        c1, c2 = centroids
        _assert_same_or_tied(got[:, 0], want[:, 0], x, c1, normalize)
        eq = got[:, 0] == want[:, 0]
        _assert_same_or_tied(got[eq, 1], want[eq, 1], x[eq] - c1[got[eq, 0]], c2, False)
        return
    x = np.asarray(x, np.float64)
    if normalize:
        x = x / np.sqrt((x ** 2).sum(-1, keepdims=True) + 1e-8) * 6.0
    for i in np.nonzero(got != want)[0]:
        dist = ((x[i][None, :] - centroids.astype(np.float64)) ** 2).sum(-1)
        two = np.argsort(dist)[:2]
        assert {int(got[i]), int(want[i])} == set(two.tolist()), (i, got[i], want[i], two)
        d0, d1 = dist[two]
        assert d1 - d0 <= TIE_RTOL * d1, (i, d0, d1)


CODEBOOKS = [("mini_codebook_256.npy", False), ("mini_codebook_1024.npy", False),
             ("mini_codebook_1024.npy", True)]


@pytest.mark.parametrize("name,normalize", CODEBOOKS)
def test_km_tokens_match_jax(features, name, normalize):
    centroids = np.load(FIXTURES / name)
    port = KMQuantizer(str(FIXTURES / name), normalize=normalize, device="cpu")
    got = port.get_indices(torch.from_numpy(features))
    assert got.dtype == torch.int32
    got = got.numpy()
    want = np.asarray(JaxKM(centroids, normalize=normalize).get_indices(features))
    _assert_same_or_tied(got, want, features, centroids, normalize)
    if not normalize:  # the codebooks were fit on unscaled features (norm ~12)
        assert len(set(got.tolist())) > 1
    np.testing.assert_array_equal(port.decode(got).numpy(), centroids[got])
    # decode clips and squeezes a trailing axis of one, as the JAX package does
    idx = np.array([[-3], [5], [len(centroids) + 7]])
    np.testing.assert_array_equal(port.decode(idx).numpy(),
                                  np.asarray(JaxKM(centroids).decode(idx)))


def test_residual_tokens_match_jax(features):
    c1 = np.load(FIXTURES / "mini_codebook_256.npy")
    c2 = np.load(FIXTURES / "mini_codebook_1024.npy")
    port = load_km_quantizer(c1, c2, device="cpu")
    assert isinstance(port, ResidualKMQuantizer)
    jax_q = JaxResidualKM(c1, c2)
    got = port.get_indices(torch.from_numpy(features)).numpy()
    want = np.asarray(jax_q.get_indices(features))
    assert got.shape == (len(features), 2)
    _assert_same_or_tied(got, want, features, (c1, c2), False)
    assert len(set(got[:, 0].tolist())) > 1
    np.testing.assert_array_equal(port.decode(got).numpy(), np.asarray(jax_q.decode(got)))


@pytest.mark.parametrize("residual", [False, True])
def test_tokenizer_matches_jax(mini, residual):
    jax_seg, port = mini
    c1 = np.load(FIXTURES / "mini_codebook_256.npy")
    kw = dict(centroids=c1)
    codebooks = c1
    if residual:
        kw["residual_centroids"] = np.load(FIXTURES / "mini_codebook_1024.npy")
        codebooks = (c1, kw["residual_centroids"])
    wavs = [_utterance(s, 4.5) for s in (11, 12)]
    tok = SylberTokenizer(port, **kw)
    assert tok.quantizer.device == port.device
    got, want = tok(wav=wavs), JaxTokenizer(jax_seg, **kw)(wav=wavs)
    for g, w in zip(got, want):
        assert g["segments"].tolist() == w["segments"].tolist()
        np.testing.assert_array_equal(g["durations"], w["durations"])
        assert g["tokens"].dtype == np.int32 and g["tokens"].shape == w["tokens"].shape
        _assert_same_or_tied(g["tokens"], w["tokens"], g["segment_features"], codebooks, False)
        np.testing.assert_array_equal(tok.decode(g["tokens"]),
                                      np.asarray(JaxTokenizer(jax_seg, **kw).decode(g["tokens"])))
    single = tok(wav=wavs[0], in_second=False)
    np.testing.assert_array_equal(single["durations"], got[0]["durations"])
    assert single["tokens"].tolist() == got[0]["tokens"].tolist()
