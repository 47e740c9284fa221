"""``python -m sylber_tpu_torch.fit_quantizer`` against the JAX package on the
CPU, over a manifest of the ``speechlike`` fixtures as WAV, FLAC and OGG and
two seeded synthetic utterances of 2 s (the fixtures are one recording:
their features nearly coincide) with ``mini_ckpt.npz`` and ``--model-config
mini_ckpt.json``, 8 centres and a residual codebook, batches of 3:

- the pooled segment features within 1e-4 of JAX's ``Segmenter`` on the
  same arrays in the same batch (the script's pooling);
- the written ``.npy`` loaded by JAX's ``KMQuantizer`` gives the port's
  ``KMQuantizer``'s indices;
- the residual equals JAX's ``feats - decode(get_indices(feats))`` on the
  same centroids (1e-6), and the residual codebook is (8, 144);
- with ``--normalize``, the residual is what
  JAX's ``ResidualKMQuantizer(normalize=True)`` encodes on the same
  centroids (1e-6), and the written pair gives its indices.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.flow.quantizer import KMQuantizer as JaxKMQuantizer
from sylber_tpu.flow.quantizer import ResidualKMQuantizer as JaxResidualKMQuantizer
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models.hubert import HubertConfig as JaxHubertConfig
from sylber_tpu_torch import fit_quantizer
from sylber_tpu_torch.quantizer import KMQuantizer, ResidualKMQuantizer
from sylber_tpu_torch.utils.audio import load_for_inference

FIXTURES = Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "mini_ckpt.json").read_text())
NAMES = {"a": "speechlike.wav", "b": "speechlike.flac", "c": "speechlike.ogg", "d": "d.wav",
         "e": "e.wav"}


def _write_synthetic(d):
    from scipy.io import wavfile

    from sylber_tpu_torch.data.synthetic import synth_utterance

    rng = np.random.RandomState(21)
    for name in ("d", "e"):
        wav = synth_utterance(rng, 32000)[0]
        wavfile.write(d / f"{name}.wav", 16000,
                      np.round(wav / np.abs(wav).max() * 30000).astype(np.int16))


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("fit_quantizer")
    for name, src in list(NAMES.items())[:3]:
        shutil.copy(FIXTURES / src, d / f"{name}{Path(src).suffix}")
    _write_synthetic(d)
    (d / "manifest.txt").write_text("\n".join(NAMES) + "\n")
    return d, _fit(d, "km8")


def _fit(d, name, *extra):
    return fit_quantizer.main(["--manifest", str(d / "manifest.txt"), "--wav-dir", str(d),
                               "--ckpt", str(FIXTURES / "mini_ckpt.npz"), "--model-config",
                               str(FIXTURES / "mini_ckpt.json"), "--n-clusters", "8",
                               "--out", str(d / f"{name}.npy"), "--residual-out",
                               str(d / f"{name}_res.npy"), "--batch-size", "3", "--device",
                               "cpu", *extra])


def test_pooled_features_match_jax_segmenter(fitted):
    d, out = fitted
    wavs = [load_for_inference(d / f"{n}{Path(s).suffix}") for n, s in NAMES.items()]
    seg = JaxSegmenter(params=jax_load_npz(str(FIXTURES / "mini_ckpt.npz")),
                       hubert_config=JaxHubertConfig(
                           num_hidden_layers=META["encoding_layer"],
                           **{k: tuple(v) if isinstance(v, list) else v
                              for k, v in META["hubert"].items()}),
                       norm_threshold=META["norm_threshold"])
    want = np.concatenate([o["segment_features"] for i in range(0, len(wavs), 3)
                           for o in seg.process(wavs[i: i + 3], in_second=False)])
    assert out["features"].shape == want.shape and len(want) >= 8
    np.testing.assert_allclose(out["features"], want, atol=1e-4, rtol=0)


def test_the_codebook_loads_into_jax_with_the_same_indices(fitted):
    d, out = fitted
    cents = np.load(d / "km8.npy")
    assert cents.shape == (8, 144) and cents.dtype == np.float32
    np.testing.assert_array_equal(cents, out["centroids"])
    feats = out["features"]
    want = np.asarray(JaxKMQuantizer(cents).get_indices(jnp.asarray(feats)))
    got = KMQuantizer(cents, device="cpu").get_indices(feats).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_residual_matches_jax_on_the_same_centroids(fitted):
    d, out = fitted
    km = JaxKMQuantizer(out["centroids"])
    feats = out["features"]
    want = feats - np.asarray(km.decode(km.get_indices(jnp.asarray(feats))))
    np.testing.assert_allclose(out["residual"], want, atol=1e-6, rtol=0)
    res = np.load(d / "km8_res.npy")
    assert res.shape == (8, 144) and np.isfinite(res).all()
    np.testing.assert_array_equal(res, out["residual_centroids"])


def _tie_gap(x, c, a, b):
    """The float64 gap between the squared distances of the normalised
    ``x`` to centres ``a`` and ``b``, relative to the scale the search
    computes them at (|x|^2 + |c|^2)."""
    x = x.astype(np.float64)
    x = x / np.linalg.norm(x) * 6.0
    d = ((x[None] - c[[a, b]].astype(np.float64)) ** 2).sum(-1)
    return abs(d[0] - d[1]) / ((x ** 2).sum() + (c[[a, b]].astype(np.float64) ** 2).sum(-1).max())


def test_the_normalized_residual_matches_jax_residual_quantizer(fitted):
    d, _ = fitted
    out = _fit(d, "km8n", "--normalize")
    feats, cents = out["features"], np.load(d / "km8n.npy")
    np.testing.assert_array_equal(cents, out["centroids"])
    rq = JaxResidualKMQuantizer(cents, np.load(d / "km8n_res.npy"), normalize=True)
    want_i = np.asarray(rq.km.get_indices(jnp.asarray(feats)))
    got_i = KMQuantizer(cents, normalize=True, device="cpu").get_indices(feats).numpy()
    # the speechlike fixtures are one recording: their features sit at
    # near-ties of near-duplicate centres, where float32 rounding decides
    ties = np.nonzero(got_i != want_i)[0]
    assert len(ties) <= 2 and all(_tie_gap(feats[i], cents, got_i[i], want_i[i]) <= 1e-6
                                  for i in ties)
    want = feats - np.asarray(rq.km.decode(jnp.asarray(got_i)))
    np.testing.assert_allclose(out["residual"], want, atol=1e-6, rtol=0)
    keep = np.setdiff1d(np.arange(len(feats)), ties)
    got = ResidualKMQuantizer(cents, out["residual_centroids"], normalize=True,
                              device="cpu").get_indices(feats[keep]).numpy()
    np.testing.assert_array_equal(got, np.asarray(rq.get_indices(jnp.asarray(feats[keep]))))
