"""The port's input pipeline against the JAX package's, and its FLAC reader.

For the same seed, ``sylber_tpu_torch.data.dataset``'s ``SpeechDataset`` (WAV
and FLAC files, segment ``.npy`` files, a noise directory, ratio sampling,
worker processes) and ``SyntheticSpeechDataset`` give exactly the batches of
``sylber_tpu.data.dataset``: crops, masks, float32 or int16 PCM, segments,
noise. The device-side stream gathers what the host collates, the
trainer's step stream does not depend on the worker count, and the FLAC
fixture decodes to the samples of its WAV twin.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sylber_tpu.data import dataset as jax_ds
from sylber_tpu.data import synthetic as jax_synth
from sylber_tpu_torch.data import dataset as port_ds
from sylber_tpu_torch.data import device as port_device
from sylber_tpu_torch.data import synthetic as port_synth
from sylber_tpu_torch.utils.audio import load_wav
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three WAV utterances (1, 3, 7 s), one FLAC (the fixture), segment
    files for each, and a noise directory with a WAV and a FLAC clip."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    wav_dir, seg_dir, noise_dir = tmp / "wavs", tmp / "segs", tmp / "noise"
    for d in (wav_dir, seg_dir, noise_dir):
        d.mkdir()
    tags = []
    for i, sec in enumerate((1.0, 3.0, 7.0)):
        n = int(sec * 16000)
        wavfile.write(str(wav_dir / f"utt{i}.wav"), 16000, (rng.randn(n) * 3000).astype(np.int16))
        tags.append(f"utt{i}")
    shutil.copy(FIXTURES / "speechlike.flac", wav_dir / "utt3.flac")
    tags.append("utt3")
    for tag in tags:
        frames = 7 * 50
        bounds = np.sort(rng.choice(np.arange(1, frames), 8, replace=False))
        np.save(seg_dir / f"{tag}.npy", bounds.reshape(4, 2))
    wavfile.write(str(noise_dir / "n0.wav"), 16000, (rng.randn(32000) * 1000).astype(np.int16))
    shutil.copy(FIXTURES / "speechlike.flac", noise_dir / "n1.flac")
    (tmp / "a.txt").write_text("\n".join(tags[:2]) + "\n")
    (tmp / "b.txt").write_text("\n".join(tags[2:]) + "\n")
    (tmp / "all.txt").write_text("\n".join(tags) + "\n")
    return tmp


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _pair(corpus, manifests, **kw):
    out = []
    for mod in (jax_ds, port_ds):
        tags = mod.load_manifest([(r, str(corpus / m)) for r, m in manifests])
        out.append(mod.SpeechDataset([str(corpus / "wavs")] * len(manifests), tags,
                                     data_dir=str(corpus / "segs"), max_len=32000,
                                     noise_dir=str(corpus / "noise"), **kw))
    return out


@pytest.mark.parametrize("transfer", ["float32", "int16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_speech_dataset_batches_equal_jax(corpus, seed, transfer):
    jd, pd = _pair(corpus, [(1.0, "all.txt")], seed=seed)
    got = list(pd.batches(2, shuffle=True, transfer=transfer))
    want = list(jd.batches(2, shuffle=True, transfer=transfer))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0]["noise"] is not None and got[0]["segments"] is not None


def test_ratio_sampling_batches_equal_jax(corpus):
    jd, pd = _pair(corpus, [(0.7, "a.txt"), (0.3, "b.txt")], seed=4, dummy_len=6)
    for g, w in zip(pd.batches(3, transfer="int16"), jd.batches(3, transfer="int16")):
        _same(g, w)


def test_worker_batches_equal_jax_and_the_step_stream_ignores_the_worker_count(corpus):
    jd, pd = _pair(corpus, [(1.0, "all.txt")], seed=2)
    for g, w in zip(pd.batches(2, shuffle=True, workers=2), jd.batches(2, shuffle=True,
                                                                      workers=2)):
        _same(g, w)
    one = port_ds.step_batches(pd, 2, seed=5, start=1, workers=0)
    two = port_ds.step_batches(pd, 2, seed=5, start=1, workers=2)
    for _ in range(3):
        _same(next(two), next(one))
    two.close()
    # step s of a stream started at 0 is step s of a stream started at s
    whole = port_ds.step_batches(pd, 2, seed=5, start=0)
    next(whole)
    _same(next(whole), next(port_ds.step_batches(pd, 2, seed=5, start=1)))


@pytest.mark.parametrize("with_segments", [True, False])
@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_synthetic_batches_equal_jax(with_segments, transfer):
    kw = dict(n_utts=6, max_len=32000, with_segments=with_segments, seed=7)
    jd, pd = jax_ds.SyntheticSpeechDataset(**kw), port_ds.SyntheticSpeechDataset(**kw)
    for g, w in zip(pd.batches(3, transfer=transfer), jd.batches(3, transfer=transfer)):
        _same(g, w)


def test_synthetic_utterances_equal_jax():
    for style in ("v1", "rich", "continuum"):
        a = port_synth.synth_utterance(np.random.RandomState(3), 20000, style=style,
                                       return_ids=True, return_art=True)
        b = jax_synth.synth_utterance(np.random.RandomState(3), 20000, style=style,
                                      return_ids=True, return_art=True)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert np.array_equal(port_synth.boundary_set(a[1]), jax_synth.boundary_set(b[1]))


def test_device_stream_gathers_the_host_collate():
    ds = port_ds.SyntheticSpeechDataset(n_utts=5, max_len=16000, seed=1)
    full = ds.collate([ds[i] for i in range(5)], transfer="int16")
    stream = port_device.device_stream(ds, 2, "cpu", transfer="int16", seed=3, start=1)
    orders = port_device.index_stream(5, 2, seed=3)
    next(orders)  # the stream started at batch 1
    for _ in range(4):
        idx, batch = next(orders), next(stream)
        for k, v in full.items():
            assert v is None or np.array_equal(batch[k].numpy(), v[idx]), k
    with pytest.raises(ValueError):
        port_device.device_stream(ds, 6, "cpu")
    host, event = port_device.to_device(full, "cpu")
    assert event is None and torch.equal(host["input_values"],
                                         torch.from_numpy(full["input_values"]))


def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(port_ds.prefetch(iter(range(20)), transform=lambda x: 2 * x)) == \
        [2 * i for i in range(20)]

    def bad():
        yield 1
        raise KeyError("boom")

    it = port_ds.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def test_flac_fixture_decodes_to_the_wav_samples():
    flac, sr = load_wav(FIXTURES / "speechlike.flac")
    wav, sr2 = load_wav(FIXTURES / "speechlike.wav")
    assert sr == sr2 == 16000 and flac.dtype == np.float32
    assert np.array_equal(flac, wav)
    from sylber_tpu.utils.flac import decode_flac as jax_decode
    from sylber_tpu_torch.utils.flac import decode_flac

    data = (FIXTURES / "speechlike.flac").read_bytes()
    for a, b in zip(decode_flac(data), jax_decode(data)):
        assert np.array_equal(a, b)


def test_ogg_raises_and_names_what_is_missing(monkeypatch):
    """OGG decodes only through libsndfile: with the probe finding none, the
    error names OGG and libsndfile."""
    from sylber_tpu_torch.utils import sndfile

    monkeypatch.setattr(sndfile, "_candidate_paths", lambda: iter(()))
    monkeypatch.setattr(sndfile, "_LIB", None)
    monkeypatch.setattr(sndfile, "_SEARCHED", False)
    with pytest.raises(ValueError, match="OGG.*libsndfile"):
        load_wav(FIXTURES / "speechlike.ogg")
