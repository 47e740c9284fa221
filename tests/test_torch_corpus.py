"""The port's corpus runners against the JAX package's, at mini width on the CPU.

A temporary corpus of WAV, FLAC and OGG files (seeded synthetic speech, one
file in a subdirectory) goes through ``python -m
sylber_tpu_torch.segment_corpus`` and ``python -m
sylber_tpu_torch.precompute_segments`` (``--device cpu``) with the trained
``mini_ckpt.npz``, fp32. The runner's segments equal the JAX runner's
(``scripts/segment_corpus.py``, whose ``Segmenter`` is given the same
parameters at the fixture's width) on the files both read (the JAX runner
globs no OGG); its stats keys and ``.npz`` layout are the JAX runner's;
``--compare`` against itself gives 1.0. ``precompute_segments`` writes the
JAX ``Segmenter``'s frame segments, and with ``--native`` the oracle's.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import sylber_tpu.api as jax_api
from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu.ops.segment_np import segment_oracle as jax_oracle
from sylber_tpu.utils.audio import load_for_inference as jax_load
from sylber_tpu_torch import precompute_segments, segment_corpus
from sylber_tpu_torch.api import Segmenter
from sylber_tpu_torch.utils import sndfile

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
META = json.loads((FIXTURES / "mini_ckpt.json").read_text())
NT = META["norm_threshold"]
# seconds of each file: distinct lengths, so that sorting is unambiguous
LENGTHS = {"a.wav": 2.3, "b.wav": 1.7, "sub/c.flac": 2.05, "d.flac": 1.3, "e.ogg": 1.55}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the test workers share the machine's cores (more
    threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pcm(seed, seconds):
    wav, _ = synth_utterance(np.random.RandomState(seed), int(seconds * 16000))
    return np.clip(wav / np.abs(wav).max() * 20000, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not sndfile.available():
        pytest.skip("libsndfile not found: FLAC and OGG files are written through it")
    d = tmp_path_factory.mktemp("corpus")
    for i, (name, seconds) in enumerate(LENGTHS.items()):
        path = d / name
        path.parent.mkdir(exist_ok=True)
        pcm = _pcm(100 + i, seconds)
        if name.endswith(".wav"):
            wavfile.write(path, 16000, pcm)
        else:
            sndfile.write(path, pcm, 16000)
    return d


def _mini_widths():
    widths = {k: tuple(v) if isinstance(v, list) else v for k, v in META["hubert"].items()}
    return dict(widths, num_hidden_layers=META["encoding_layer"])


def _jax_segmenter(**kw):
    """The JAX ``Segmenter`` at the fixture's width, with the fixture's
    parameters, keeping the caller's dtype and precision."""
    cfg = kw.pop("hubert_config")
    kw.pop("model_ckpt", None)
    return JaxSegmenter(
        params=jax_load_npz(str(FIXTURES / "mini_ckpt.npz")),
        hubert_config=JaxConfig(dtype=cfg.dtype, precision=cfg.precision,
                                frontend_dtype=cfg.frontend_dtype, **_mini_widths()), **kw)


def _run_jax_runner(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location("jax_segment_corpus",
                                                  ROOT / "scripts" / "segment_corpus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(jax_api, "Segmenter", _jax_segmenter)
    monkeypatch.setattr(sys, "argv", ["segment_corpus.py", *argv])
    module.main()


def test_segment_corpus_matches_jax_runner(corpus, tmp_path, monkeypatch, capsys):
    common = ["--audio-dir", str(corpus), "--ckpt", str(FIXTURES / "mini_ckpt.npz"),
              "--norm-threshold", str(NT), "--dtype", "float32", "--batch-size", "2"]
    ours = tmp_path / "ours.npz"
    out = segment_corpus.main([*common, "--out", str(ours),
                               "--model-config", str(FIXTURES / "mini_ckpt.json"),
                               "--device", "cpu"])
    assert sorted(out["results"]) == sorted(LENGTHS)
    assert all(len(s) for s in out["results"].values())
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out["stats"]

    theirs = tmp_path / "theirs.npz"
    _run_jax_runner(monkeypatch, [*common, "--out", str(theirs)])
    want_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, want = np.load(ours), np.load(theirs)
    assert list(out["stats"]) == list(want_stats)  # the same keys, in the same order
    assert set(want.files) == set(got.files) - {"e.ogg"}  # the JAX runner globs no OGG
    for k in want.files:
        if k == "stats":
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tolist() == want[k].tolist(), k
    assert json.loads(str(got["stats"])) == out["stats"]
    assert out["stats"]["utts"] == want_stats["utts"] + 1
    ogg_s = len(jax_load(corpus / "e.ogg")) / 16000
    assert out["stats"]["audio_seconds"] == pytest.approx(want_stats["audio_seconds"] + ogg_s)

    again = segment_corpus.main([*common, "--out", str(tmp_path / "again.npz"),
                                 "--model-config", str(FIXTURES / "mini_ckpt.json"),
                                 "--device", "cpu", "--no-warmup", "--compare", str(ours)])
    assert again["compare"] == {"boundary_f1_vs_compare": 1.0, "n_compared": len(LENGTHS)}


def test_precompute_segments_device_and_native(corpus, tmp_path):
    flat = tmp_path / "wavs"
    flat.mkdir()
    for name in LENGTHS:
        shutil.copy(corpus / name, flat / Path(name).name)
    tags = sorted(Path(n).stem for n in LENGTHS)
    manifest = tmp_path / "tags.txt"
    manifest.write_text("\n".join(tags) + "\n")
    args = ["--manifest", str(manifest), "--wav-dir", str(flat),
            "--ckpt", str(FIXTURES / "mini_ckpt.npz"),
            "--model-config", str(FIXTURES / "mini_ckpt.json"),
            "--norm-threshold", str(NT), "--device", "cpu"]
    assert precompute_segments.main([*args, "--out-dir", str(tmp_path / "dev")]) == len(tags)
    assert precompute_segments.main([*args, "--out-dir", str(tmp_path / "nat"),
                                     "--native"]) == len(tags)

    files = [next(flat.glob(f"{t}.*")) for t in tags]
    wavs = [jax_load(f) for f in files]
    want = JaxSegmenter(params=jax_load_npz(str(FIXTURES / "mini_ckpt.npz")),
                        hubert_config=JaxConfig(**_mini_widths()), norm_threshold=NT
                        ).process(wavs, in_second=False)
    port = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), norm_threshold=NT,
                     hubert_config=segment_corpus.segmenter_config(
                         "float32", "highest", _mini_widths()), device="cpu")
    hidden = [o["hidden_states"] for o in port.process(wavs, in_second=False)]
    for t, w, h in zip(tags, want, hidden):
        dev = np.load(tmp_path / "dev" / f"{t}.npy")
        nat = np.load(tmp_path / "nat" / f"{t}.npy")
        assert dev.dtype == nat.dtype == np.int64
        assert dev.tolist() == w["segments"].tolist() and len(dev), t
        oracle, margin = jax_oracle(h, NT, META["merge_threshold"], return_margin=True)
        assert margin > 1e-4, (t, margin)  # so the native segments must equal the oracle's
        assert nat.tolist() == oracle.tolist() == dev.tolist(), t
