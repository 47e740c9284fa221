"""The port's pitch path (``sylber_tpu_torch/ops/pitch.py``) and its
pitch-token and k-means quantizers against the JAX package on the CPU.

- ``frame_f0``: F0 equal to JAX's on every frame but argmax near-ties of
  the autocorrelation (pocketfft rounds apart from XLA's FFT), held to 2
  of 188 frames, each a tie within 1e-5 (0 today); the strength within
  1e-5; silence gives zeros;
- the segment pooling and fill equal JAX's; ``segment_pitch_cond`` (with
  and without the ``ScalarPitchQuantizer``) equals JAX's on a synthetic
  utterance and tracks its analytic pitch (r > 0.9);
- the explicit-pitch resynthesis of ``mini_synth_rich_pitch.npz`` on the
  wav path: JAX's segments, art within 1e-4 of the largest;
- ``ScalarPitchQuantizer`` and ``KMQuantizer.__call__`` equal JAX's.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.flow import quantizer as jq
from sylber_tpu.ops import pitch as jp
from sylber_tpu_torch.flow import quantizer as tq
from sylber_tpu_torch.ops import pitch as tp
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"


def _harmonic(f0_hz, n, sr=16000, harmonics=4):
    t = np.arange(n) / sr
    return sum(np.sin(2 * np.pi * f0_hz * (k + 1) * t) / (k + 1)
               for k in range(harmonics)).astype(np.float32)


def _rich_utterance(seed=3, n=80000):
    from sylber_tpu_torch.data.dataset import _zero_mean_unit_var
    from sylber_tpu_torch.data.synthetic import synth_utterance

    wav, segs, art = synth_utterance(np.random.RandomState(seed), n, return_art=True,
                                     style="rich")
    pad = np.zeros(160, np.float32)
    return np.concatenate([pad, _zero_mean_unit_var(wav), pad]), np.asarray(segs), art


def test_frame_f0_matches_jax_but_near_ties():
    rng = np.random.RandomState(0)
    wavs = [_harmonic(f, 16000) + 0.01 * rng.randn(16000).astype(np.float32)
            for f in (95.0, 150.0, 230.0)]
    wavs.append(0.02 * rng.randn(16000).astype(np.float32))  # unvoiced
    batch = np.stack(wavs)
    f0_j, s_j = (np.asarray(x) for x in jp.frame_f0(jnp.asarray(batch)))
    f0_t, s_t = (x.numpy() for x in tp.frame_f0(torch.from_numpy(batch)))
    assert f0_t.shape == f0_j.shape == (4, 47)
    # a frame may differ only at a near-tie: the float64 autocorrelations at
    # the two chosen lags within 1e-5 of each other (none differs today)
    differ = list(zip(*np.nonzero(f0_t != f0_j)))
    for b, f in differ:
        seg = batch[b, f * 320: f * 320 + 1024].astype(np.float64)
        seg -= seg.mean()
        ac = np.correlate(seg, seg, "full")[1023:] / (seg ** 2).sum()
        lags = [int(round(16000 / x[b, f])) for x in (f0_t, f0_j)]
        assert abs(ac[lags[0]] - ac[lags[1]]) <= 1e-5, (b, f, lags)
    assert len(differ) <= 2, differ
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    # silence
    f0, s = tp.frame_f0(torch.zeros(1, 8000))
    assert float(f0.abs().sum()) == 0 and float(s.abs().sum()) == 0
    assert tp.frame_f0(torch.zeros(2, 500))[0].shape == (2, 0)


def test_segment_mean_and_fill_equal_jax():
    values = np.array([[1.0, 2.0, 3.0, 4.0, 10.0, 20.0, 0.0, 0.0]], np.float32)
    voiced = np.array([[True, True, False, True, True, True, False, False]])
    segments = np.array([[[0, 3], [3, 6], [6, 8], [0, 0]]], np.int32)
    num = np.array([3], np.int32)
    mean, has = tp.segment_mean_pitch(*(torch.from_numpy(a) for a in (values, voiced, segments,
                                                                       num)))
    np.testing.assert_allclose(mean.numpy()[0, :3], [1.5, (4 + 10 + 20) / 3, 0.0])
    assert has.numpy()[0].tolist() == [True, True, False, False]
    filled = tp.fill_segment_values(mean, has, torch.from_numpy(segments), torch.from_numpy(num), 8)
    jm, jh = jp.segment_mean_pitch(*(jnp.asarray(a) for a in (values, voiced, segments, num)))
    want = jp.fill_segment_values(jm, jh, jnp.asarray(segments), jnp.asarray(num), 8)
    np.testing.assert_array_equal(filled.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [False, True])
def test_segment_pitch_cond_equals_jax_and_tracks_truth(quantized):
    wav, segs, art = _rich_utterance()
    L = art.shape[0]
    args_t = (torch.from_numpy(wav)[None], torch.from_numpy(segs)[None],
              torch.tensor([len(segs)]), L)
    args_j = (jnp.asarray(wav)[None], jnp.asarray(segs)[None], jnp.asarray([len(segs)]), L)
    got = tp.segment_pitch_cond(*args_t, pitch_quantizer=tq.ScalarPitchQuantizer(32)
                                if quantized else None)[0].numpy()
    want = np.asarray(jp.segment_pitch_cond(*args_j, pitch_quantizer=jq.ScalarPitchQuantizer(32)
                                            if quantized else None)[0])
    np.testing.assert_allclose(got, want, atol=1e-6)
    truth = np.zeros(L, np.float32)  # the analytic per-segment voiced mean
    for a, b in segs:
        v = art[a:b, 13] > 0.02
        if v.any():
            truth[a:b] = art[a:b, 12][v].mean()
    voiced = truth != 0
    x, y = got[voiced], truth[voiced]
    assert voiced.sum() > 50 and np.corrcoef(x, y)[0, 1] > 0.9


def test_scalar_pitch_quantizer_and_km_call_equal_jax():
    v = np.linspace(-0.7, 1.4, 41, dtype=np.float32)[None]
    has = np.ones_like(v, bool)
    has[0, 5] = False
    q, jqz = tq.ScalarPitchQuantizer(64), jq.ScalarPitchQuantizer(64)
    idx = q.get_indices(torch.from_numpy(v), torch.from_numpy(has))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jqz.get_indices(jnp.asarray(v),
                                                                          jnp.asarray(has))))
    (dv, dh), (jv, jh) = q.decode(idx), jqz.decode(jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(dh.numpy(), np.asarray(jh))
    assert q.vocab_size == 65 and int(idx[0, 5]) == 0
    with pytest.raises(ValueError):
        tq.ScalarPitchQuantizer(1)
    rng = np.random.RandomState(0)
    cents, x = rng.randn(50, 16).astype(np.float32), rng.randn(3, 7, 16).astype(np.float32)
    got = tq.KMQuantizer(cents, device="cpu")(x)
    want = jq.KMQuantizer(cents)(jnp.asarray(x))
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["quantize"].numpy(), np.asarray(want["quantize"]))
    np.testing.assert_allclose(float(got["commitment_loss"]), float(want["commitment_loss"]),
                               rtol=1e-6)


def test_explicit_pitch_resynthesis_matches_jax():
    from sylber_tpu import synthesis as jsyn
    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config
    from sylber_tpu_torch import synthesis as tsyn

    mc = json.loads((FIXTURES / "mini_synth_rich_pitch.json").read_text())["config"]["model"]
    trained = load_params_npz(str(FIXTURES / "mini_synth_rich_pitch.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jax_synth = jsyn.SegmentSynthesis(config=jax_config(mc), params=jsyn.SynthesisParams(
        enc, trained["input_mlp"], trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=tsyn.synthesis_config_from_dict(mc),
                                 params={"hubert": enc, **trained}, device="cpu")
    wav = np.stack([_rich_utterance(seed, 48000)[0] for seed in (11, 12)])
    nt = float(mc["norm_threshold"])
    want, want_segs = jax_synth.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    got, got_segs = port.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    for a, b in zip(got_segs, want_segs):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="pitch_cond"):
        port.resynthesize(features=np.zeros((1, 8, 144), np.float32), steps=2)
