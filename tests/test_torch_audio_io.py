"""The port's audio reader against the JAX package's, and its decoder order.

``load_wav`` gives JAX's samples bit for bit on the FLAC, WAV and OGG
fixtures. FLAC goes through libsndfile when it is found, then the native
decoder, then the pure-Python one, each to the same samples; OGG goes
through libsndfile only, and without it raises a ``ValueError`` that names
what is missing.
"""

from pathlib import Path

import numpy as np
import pytest

from sylber_tpu.utils.audio import load_for_inference as jax_load_for_inference
from sylber_tpu.utils.audio import load_wav as jax_load_wav
from sylber_tpu_torch.utils import audio, native, sndfile
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"


def _require_sndfile():
    if not sndfile.available():
        pytest.skip("libsndfile not found")


@pytest.mark.parametrize("name", ["speechlike.flac", "speechlike.wav", "speechlike.ogg"])
def test_load_wav_matches_jax_bit_for_bit(name):
    if name.endswith(".ogg"):
        _require_sndfile()
    got, sr = audio.load_wav(FIXTURES / name)
    want, want_sr = jax_load_wav(FIXTURES / name)
    assert sr == want_sr == 16000 and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)
    np.testing.assert_array_equal(audio.load_for_inference(FIXTURES / name),
                                  jax_load_for_inference(FIXTURES / name))


def _hide_sndfile(monkeypatch):
    """As on a host without libsndfile: the probe finds nothing."""
    monkeypatch.setattr(sndfile, "_candidate_paths", lambda: iter(()))
    monkeypatch.setattr(sndfile, "_LIB", None)
    monkeypatch.setattr(sndfile, "_SEARCHED", False)


def test_flac_dispatch_order(monkeypatch):
    _require_sndfile()
    path = FIXTURES / "speechlike.flac"
    want, _ = jax_load_wav(path)
    calls = []

    def record(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sndfile, "read", record("sndfile", sndfile.read))
    monkeypatch.setattr(native, "decode_flac_native",
                        record("native", native.decode_flac_native))
    from sylber_tpu_torch.utils import flac
    monkeypatch.setattr(flac, "decode_flac", record("python", flac.decode_flac))

    assert np.array_equal(audio.load_wav(path)[0], want) and calls == ["sndfile"]
    calls.clear()
    _hide_sndfile(monkeypatch)
    assert np.array_equal(audio.load_wav(path)[0], want) and calls == ["native"]
    calls.clear()

    def no_toolchain(data):
        calls.append("native")
        raise native.NativeUnavailable("no g++")

    monkeypatch.setattr(native, "decode_flac_native", no_toolchain)
    assert np.array_equal(audio.load_wav(path)[0], want) and calls == ["native", "python"]


def test_ogg_needs_libsndfile(monkeypatch, tmp_path):
    _require_sndfile()
    calls = []
    read = sndfile.read
    monkeypatch.setattr(sndfile, "read", lambda *a, **k: calls.append(a[0]) or read(*a, **k))
    audio.load_wav(FIXTURES / "speechlike.ogg")
    assert calls == [FIXTURES / "speechlike.ogg"]
    monkeypatch.undo()
    _hide_sndfile(monkeypatch)
    assert not sndfile.available()
    with pytest.raises(ValueError, match="OGG.*libsndfile"):
        audio.load_wav(FIXTURES / "speechlike.ogg")
    odd = tmp_path / "x.aiff"
    odd.write_bytes(b"FORM" + bytes(60))
    with pytest.raises(ValueError, match="container b'FORM'.*libsndfile"):
        audio.load_wav(odd)
