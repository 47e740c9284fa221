"""The vocoder proof (``sylber_tpu_torch/vocoder_proof.py``) against
``scripts/train_vocoder_proof.py`` on the CPU.

- ``f0_track_autocorr`` (a numpy copy) on ``speechlike.wav`` and a synthetic
  utterance: rtol 1e-6;
- ``evaluate`` of the trained ``mini_vocoder.npz`` on 2 held-out crops
  (seed 777) against the script's (its jitted generator; JAX's noise draw
  passed to the port): every metric within 1e-3.

``main`` and its resume: ``test_torch_vocoder_proof_resume.py``.
"""

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from _torch_proof_helpers import FIXTURES, jax_noise
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.vocoder.hifigan import Generator as JaxGenerator
from sylber_tpu.vocoder.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from sylber_tpu.vocoder.mel import MelConfig as JaxMelConfig
from sylber_tpu.vocoder.sparc import SparcDecoder as JaxSparc
from sylber_tpu.vocoder.sparc import SparcDecoderConfig as JaxSparcConfig
from sylber_tpu_torch import vocoder_proof as vp
from sylber_tpu_torch.io.checkpoint import generator_state_dict_from_jax
from sylber_tpu_torch.vocoder import HiFiGANConfig
from sylber_tpu_torch.vocoder.hifigan import Generator

import train_vocoder_proof as jax_vp  # noqa: E402  (scripts/, on the path by the helpers)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def _synthetic_utterance():
    from sylber_tpu_torch.data.synthetic import synth_utterance

    return synth_utterance(np.random.RandomState(3), 24000, style="rich")[0]


@pytest.mark.parametrize("which", ["speechlike", "synthetic"])
def test_f0_track_autocorr_matches_the_script(which):
    if which == "speechlike":
        sr, pcm = wavfile.read(FIXTURES / "speechlike.wav")
        wav = pcm.astype(np.float32) / 32768.0
    else:
        wav = _synthetic_utterance()
    want = jax_vp.f0_track_autocorr(wav)
    got = vp.f0_track_autocorr(wav)
    assert len(got[0]) > 10 and (got[1] > 0.4).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_features_from_art_match_the_script():
    _, arts, pitch_mean = vp.build_corpus(3, seed=5, style="rich")
    dec = JaxSparc(JaxSparcConfig(generator=JaxHiFiGANConfig(**jax_vp.GEN_CFG)),
                   params=jax_load_npz(str(FIXTURES / "mini_vocoder.npz")))
    want = np.asarray(dec.features_from_art(arts, pitch_mean))
    np.testing.assert_allclose(vp.features_from_art(arts, pitch_mean), want, atol=1e-6)


def test_evaluate_matches_the_script_on_the_mini_vocoder():
    tree = jax_load_npz(str(FIXTURES / "mini_vocoder.npz"))
    wavs, arts, pitch_mean = vp.build_corpus(2, seed=777)
    feats = vp.features_from_art(arts, pitch_mean)
    gen = JaxGenerator(JaxHiFiGANConfig(**jax_vp.GEN_CFG))
    gen_apply = jax.jit(lambda p, f, c: gen.apply({"params": p}, f, c))
    want = jax_vp.evaluate(gen_apply, tree, feats, wavs, JaxMelConfig())
    port = Generator(HiFiGANConfig(**vp.GEN_CFG))
    port.load_state_dict(generator_state_dict_from_jax(tree))
    got = vp.evaluate(port, feats, wavs, precision="highest",
                      noise=jax_noise((2, feats.shape[1] * 320)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3, (k, got[k], v)
