"""The port's HTTP front end (``sylber_tpu_torch.serve_http``) on a free
localhost port, over a tiny seeded port ``Segmenter`` on the CPU: /segment
(thresholds, ``in_second``, int16 and float32 bodies) equals the direct
``Segmenter`` call, /tokenize gives nearest-centroid ids, /stats and
/healthz answer, errors answer 400 / 404 / 413 and leave the server up, and
a stack that is not there (/resynthesize without a synthesis stack,
audio=1 without a vocoder, /tokenize without centroids) answers 503.
/resynthesize over the trained mini fixtures (``mini_synth``,
``mini_vocoder``), built from files as ``--synthesis-ckpt`` /
``--vocoder-ckpt`` build them, answers the art of ``resynthesize`` and a
16 kHz WAV. Also ``python -m sylber_tpu_torch.serve_http`` parses its
arguments and refuses to start without a GPU unless ``--device cpu`` is
given.
"""

import http.client
import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from sylber_tpu_torch import Segmenter, serve_http
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.quantizer import KMQuantizer
from sylber_tpu_torch.serve import SegmenterServer
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(num_hidden_layers=1, hidden_size=32, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)


def _serve(server, **kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.build_handler(server, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def stack():
    seg = Segmenter(hubert_config=HubertConfig(**TINY), norm_threshold=0.5,
                    merge_threshold=0.9, device="cpu")
    server = SegmenterServer(seg, max_batch=4, max_wait_ms=5.0)
    centroids = np.random.RandomState(0).randn(7, 32).astype(np.float32)
    httpd, base = _serve(server, quantizer=KMQuantizer(centroids, device="cpu"))
    yield seg, centroids, base
    httpd.shutdown()
    httpd.server_close()
    server.stop()


def _wav(seconds=1.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (np.sin(2 * np.pi * 170 * t) * 0.4 + 0.01 * rng.randn(len(t))).astype(np.float32)


def _post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"X-Dtype": "float32", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers.get("Content-Type"), json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def test_segment_endpoint_with_thresholds(stack):
    seg, _, base = stack
    ct, out = _post(base, "/segment?norm_threshold=0.2&merge_threshold=0.95&in_second=0",
                    _wav().tobytes())
    assert ct == "application/json"
    assert out["num_segments"] == len(out["segments"]) > 0
    direct = seg.process([_wav()], in_second=False, norm_threshold=0.2,
                         merge_threshold=0.95, return_hidden=False)[0]
    assert out["segments"] == direct["segments"].tolist()
    np.testing.assert_array_equal(np.asarray(out["segment_features"], np.float32),
                                  direct["segment_features"])
    _, sec = _post(base, "/segment?norm_threshold=0.2&merge_threshold=0.95", _wav().tobytes())
    assert sec["num_segments"] == out["num_segments"]
    np.testing.assert_allclose(np.asarray(sec["segments"]) * 50.0,
                               np.asarray(out["segments"]), atol=1e-6)


def test_int16_body(stack):
    seg, _, base = stack
    pcm = np.clip(_wav() * 32767, -32768, 32767).astype("<i2")
    _, out = _post(base, "/segment?norm_threshold=0.2&in_second=0", pcm.tobytes(),
                   headers={"X-Dtype": "int16"})
    assert out["num_segments"] > 0
    direct = seg.process([pcm.astype(np.float32) / 32768.0], in_second=False,
                         norm_threshold=0.2, return_hidden=False)[0]
    assert out["segments"] == direct["segments"].tolist()


def test_tokenize_endpoint(stack):
    seg, centroids, base = stack
    _, out = _post(base, "/tokenize?norm_threshold=0.2&in_second=0", _wav().tobytes())
    assert out["num_segments"] == len(out["tokens"]) == len(out["durations"]) > 0
    direct = seg.process([_wav()], in_second=False, norm_threshold=0.2,
                         return_hidden=False)[0]
    feats = direct["segment_features"].astype(np.float64)
    nearest = ((feats[:, None] - centroids[None].astype(np.float64)) ** 2).sum(-1).argmin(1)
    assert out["tokens"] == nearest.tolist()
    segs = np.asarray(out["segments"])
    assert out["durations"] == (segs[:, 1] - segs[:, 0]).tolist()


def test_errors_do_not_kill_server(stack):
    _, _, base = stack
    with pytest.raises(urllib.error.HTTPError) as e:  # under one receptive field
        _post(base, "/segment", np.zeros(10, "<f4").tobytes())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/segment?merge_threshold=abc", _wav().tobytes())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/nope", b"")
    assert e.value.code == 404
    assert _get(base, "/healthz")["ok"]
    stats = _get(base, "/stats")
    assert stats["requests"] > 0 and stats["completed"] > 0
    assert stats["mean_batch_size"] >= 1.0


def test_missing_stacks_and_large_bodies():
    seg = Segmenter(hubert_config=HubertConfig(**TINY), device="cpu")
    server = SegmenterServer(seg, max_batch=2, max_wait_ms=5.0)
    httpd, base = _serve(server, max_body_bytes=64000)  # no quantizer
    try:
        for path in ("/tokenize", "/resynthesize"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, path, _wav(0.5).tobytes())
            assert e.value.code == 503
        # the front end answers from the declared length, before the body:
        # declare 96,000 bytes and send none, so no unread body is left on
        # the socket when the server closes it
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.putrequest("POST", "/segment")
        conn.putheader("Content-Length", "96000")
        conn.endheaders()
        response = conn.getresponse()
        assert response.status == 413 and "limit" in json.loads(response.read())["error"]
        conn.close()
        _, out = _post(base, "/segment", _wav(0.5).tobytes())
        assert out["num_segments"] == len(out["segments"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_module_entry_point_needs_a_device_choice():
    env = {"PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    run = subprocess.run([sys.executable, "-m", "sylber_tpu_torch.serve_http", "--help"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0 and "--device" in run.stdout
    assert "--synthesis-ckpt" in run.stdout and "--vocoder-ckpt" in run.stdout
    run = subprocess.run([sys.executable, "-m", "sylber_tpu_torch.serve_http",
                          "--encoding-layer", "1", "--port", "0"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode != 0 and "device='cpu'" in run.stderr


def test_resynthesize_endpoint_with_the_mini_fixtures(tmp_path):
    """The stack built from files the way the flags build it (an ``.npz``
    of the three subtrees and the fixture's metadata as the config; the
    vocoder's ``.npz`` and its generator config): JSON art equal to a
    direct ``resynthesize``, audio=1 a WAV of 320 samples a frame, 503
    without a vocoder for audio=1, and a directory that is no Orbax
    checkpoint refused."""
    from sylber_tpu_torch.io.checkpoint import load_params_npz, save_tree_npz

    tree = {"hubert": load_params_npz(str(ROOT / "tests/fixtures/mini_ckpt.npz")),
            **load_params_npz(str(ROOT / "tests/fixtures/mini_synth.npz"))}
    save_tree_npz(str(tmp_path / "synth.npz"), tree)
    synth, vocoder = serve_http.build_synthesis_stack(
        str(tmp_path / "synth.npz"), str(ROOT / "tests/fixtures/mini_synth.json"), "cpu",
        vocoder_ckpt=str(ROOT / "tests/fixtures/mini_vocoder.npz"),
        vocoder_config=str(ROOT / "tests/fixtures/mini_vocoder.json"))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="not an Orbax checkpoint"):
        serve_http.build_synthesis_stack(str(tmp_path / "orbax"),
                                         str(ROOT / "tests/fixtures/mini_synth.json"), "cpu")
    seg = Segmenter(hubert_config=HubertConfig(**TINY), device="cpu")
    server = SegmenterServer(seg, max_batch=2, max_wait_ms=5.0)
    httpd, base = _serve(server, synth=synth, vocoder=vocoder)
    bare, bare_base = _serve(server, synth=synth)
    wav = _wav(1.0, seed=3)
    try:
        ct, out = _post(base, "/resynthesize?steps=3", wav.tobytes())
        direct, segs = synth.resynthesize(input_values=wav[None], steps=3)
        assert ct == "application/json"
        np.testing.assert_allclose(np.asarray(out["art"]), direct[0], rtol=1e-6, atol=1e-6)
        assert np.asarray(out["art"]).shape == (49, 14)
        assert out["segments"] == segs[0].tolist()
        req = urllib.request.Request(base + "/resynthesize?steps=2&audio=1", data=wav.tobytes(),
                                     headers={"X-Dtype": "float32"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers.get("Content-Type") == "audio/wav"
            with wave.open(io.BytesIO(r.read())) as w:
                assert (w.getframerate(), w.getsampwidth(), w.getnframes()) == (16000, 2, 49 * 320)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(bare_base, "/resynthesize?audio=1", wav.tobytes())
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/resynthesize?steps=x", wav.tobytes())
        assert e.value.code == 400
    finally:
        for h in (httpd, bare):
            h.shutdown()
            h.server_close()
        server.stop()
