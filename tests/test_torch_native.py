"""The port's native (C++) host components against the JAX package's.

The port builds its own copies of ``native/flac.cc`` and ``native/segment.cc``
with g++ into ``build/native/``. Its native FLAC decoder, its pure-Python one
and the JAX package's native one give the same samples, bit for bit, on the
checked-in fixture and on libFLAC encodes (libsndfile's, where it is found);
corrupt input raises. Its native segmenter and its numpy oracle give the
JAX oracle's segments, and so does the port's plain ``segment_batch``: exact
equality wherever the oracle's decision margin exceeds 1e-4, valid
segmentations where a decision sits within float32 round-off of a threshold
(the rule of ``tests/unit/test_native_segment.py``).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sylber_tpu.ops.segment_np import segment_oracle as jax_oracle
from sylber_tpu.utils import native as jax_native
from sylber_tpu_torch.ops.segment import segment_batch
from sylber_tpu_torch.ops.segment_np import frame_norms, pool_segment_features, segment_oracle
from sylber_tpu_torch.utils import native, sndfile
from sylber_tpu_torch.utils.flac import FlacError, decode_flac

FIXTURES = Path(__file__).parent / "fixtures"
NEAR_TIE_MARGIN = 1e-4  # tests/unit/test_native_segment.py's gate

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def test_native_library_is_built_from_the_port_source_into_build_native():
    so = native.build("segment")
    assert so.parent == Path(__file__).resolve().parents[1] / "build" / "native"
    assert so == native.library_path("segment") and so.exists()
    assert native.SOURCES == Path(native.__file__).resolve().parents[1] / "native"


def _synth(rng, n, sr=16000, stereo=False):  # tests/unit/test_flac.py's signal
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t) * np.clip(np.sin(2 * np.pi * 4 * t), 0, None)
         + 0.05 * np.sin(2 * np.pi * 620 * t) + 0.01 * rng.randn(n))
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    if stereo:
        return np.stack([pcm, np.clip(np.roll(x, 7) * 30000, -32768, 32767).astype(np.int16)])
    return pcm


def _decoders_agree(data, want, sr):
    for decode in (native.decode_flac_native, decode_flac, jax_native.decode_flac_native):
        pcm, got_sr, bps = decode(data)
        assert got_sr == sr and bps == 16
        assert np.array_equal(pcm, want), decode


def test_flac_fixture_bit_exact_across_decoders():
    sr, pcm = wavfile.read(FIXTURES / "speechlike.wav")
    _decoders_agree((FIXTURES / "speechlike.flac").read_bytes(),
                    pcm.astype(np.int32)[None], sr)


@pytest.mark.parametrize("case", ["mono", "mono_odd", "stereo", "sr44k", "short", "silence",
                                  "constant"])
def test_flac_decoders_against_libflac(case, tmp_path):
    if not sndfile.available():
        pytest.skip("libsndfile not found")
    rng = np.random.RandomState(sum(map(ord, case)))
    sr = 44100 if case == "sr44k" else 16000
    pcm = {"silence": lambda: np.zeros(8000, np.int16),
           "constant": lambda: np.full(5000, -321, np.int16),
           "short": lambda: _synth(rng, 100),
           "mono_odd": lambda: _synth(rng, 16001 + 4096),
           "stereo": lambda: _synth(rng, 24000, stereo=True)}.get(case, lambda: _synth(rng, sr, sr))()
    f = tmp_path / f"{case}.flac"
    sndfile.write(f, pcm, sr)
    want = (pcm[None] if pcm.ndim == 1 else pcm).astype(np.int32)
    _decoders_agree(f.read_bytes(), want, sr)
    got, got_sr = sndfile.read(f, dtype="int16")
    assert got_sr == sr and np.array_equal(got.astype(np.int32), want)


def test_corrupt_flac_raises():
    data = (FIXTURES / "speechlike.flac").read_bytes()
    with pytest.raises(ValueError):
        native.decode_flac_native(data[: len(data) // 2])  # truncated frames
    with pytest.raises(ValueError):
        native.decode_flac_native(b"RIFF" + data[4:])  # wrong magic
    with pytest.raises(FlacError):
        decode_flac(data[:40])  # truncated inside STREAMINFO


def _states(rng, L=200, d=48):  # tests/unit/test_native_segment.py's plateaus
    states = np.zeros((L, d), np.float32)
    i = 0
    while i < L:
        span = min(int(rng.randint(2, 14)), L - i)
        if rng.rand() < 0.25:
            states[i:i + span] = rng.randn(span, d) * 0.05
        else:
            proto = rng.randn(d)
            proto = proto / np.linalg.norm(proto) * rng.uniform(4, 9)
            states[i:i + span] = proto + rng.randn(span, d) * 0.15
        i += span
    return states


def _plain(states, nt, mt):
    """The port's ``segment_batch`` (its plain versions on the CPU), one row."""
    res = segment_batch(torch.from_numpy(states[None]), nt, mt)
    k = int(res.num_segments[0])
    return res.segments[0, :k].numpy().astype(np.int64), res.features[0, :k].numpy()


def test_native_and_oracles_match_jax_oracle():
    rng = np.random.RandomState(0)
    for trial in range(15):
        st = _states(rng, L=int(rng.randint(20, 300)))
        nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.5, 0.95))
        want = jax_oracle(st, nt, mt).tolist()
        assert native.segment_native(st, nt, mt).tolist() == want, trial
        assert segment_oracle(st, nt, mt).tolist() == want, trial
        segs, feats = _plain(st, nt, mt)
        assert segs.tolist() == want, trial
        np.testing.assert_allclose(feats, pool_segment_features(st, segs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(frame_norms(st), np.sqrt((st ** 2).sum(-1) + 1e-8))


def _valid(segs, L):
    prev_end = 0
    for s, e in segs:
        assert 0 <= s < e <= L and s >= prev_end
        prev_end = e


def _near_tie_states(rng, d, theta, jitters):
    """Frames each at ``theta`` (plus a drawn jitter) from the one before,
    an occasional one silent."""
    L = int(rng.randint(12, 60))
    states = np.zeros((L, d), np.float32)
    u = rng.randn(d)
    u /= np.linalg.norm(u)
    for i in range(L):
        v = rng.randn(d)
        v -= v @ u * u
        v /= np.linalg.norm(v)
        ang = theta + rng.choice(jitters)
        states[i] = (np.cos(ang) * u + np.sin(ang) * v) * rng.uniform(4, 8)
        if rng.rand() < 0.15:
            states[i] *= 0.01
        u = states[i] / np.linalg.norm(states[i])
    return states


@pytest.mark.parametrize("jitters", [(-1e-6, -1e-7, 0.0, 1e-7, 1e-6), (-3e-3, 3e-3)],
                         ids=["within-1e-6", "off-by-3e-3"])
def test_native_near_tie_margin_gate(jitters):
    """Pass-1 cosines placed within ``jitters`` (in angle) of the merge
    threshold: exact equality with the oracle where its margin exceeds 1e-4,
    valid segmentations where it does not. The 1e-6 case is the JAX test's
    (every decision a near tie); at 3e-3 most trials are decided."""
    rng = np.random.RandomState(7)
    mt = 0.8
    exact = 0
    for trial in range(40):
        states = _near_tie_states(rng, 64, np.arccos(mt), jitters)
        want, margin = jax_oracle(states, 2.0, mt, return_margin=True)
        ours, our_margin = segment_oracle(states, 2.0, mt, return_margin=True)
        assert ours.tolist() == want.tolist() and our_margin == margin
        got = native.segment_native(states, 2.0, mt)
        plain = _plain(states, 2.0, mt)[0]
        for segs in (got, plain, want):
            _valid(segs, len(states))
        if margin > NEAR_TIE_MARGIN:
            assert got.tolist() == want.tolist() == plain.tolist(), (trial, margin)
            exact += 1
    assert exact >= (20 if jitters[-1] > 1e-4 else 0), exact


def test_native_batch_matches_oracle_and_single_rows():
    rng = np.random.RandomState(1)
    batch = np.stack([_states(rng, L=120) for _ in range(4)])
    outs = native.segment_native_batch(batch, 2.0, 0.8)
    assert len(outs) == 4
    for b in range(4):
        want = jax_oracle(batch[b], 2.0, 0.8).tolist()
        assert outs[b].tolist() == want == native.segment_native(batch[b], 2.0, 0.8).tolist()
    assert native.segment_native(np.zeros((10, 8), np.float32), 2.0, 0.8).shape == (0, 2)
