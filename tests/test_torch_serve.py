"""The port's ``SegmenterServer`` and the serving side of its ``Segmenter``.

- The batching mechanics of ``sylber_tpu.serve`` against a deterministic
  fake segmenter: exact routing under concurrency, options that never mix,
  a failed batch failing only its own requests, draining on stop, eager
  rejection of a bad request, bounded latency at low load, exact routing in
  pipelined mode.
- With the port's ``Segmenter`` on ``mini_ckpt.npz`` (CPU): a served
  request equals ``process([wav])`` bit for bit, a served batch equals the
  same direct batch, ``in_second`` toggles.
- ``Segmenter.process_async`` enqueues all the work and ``finalize`` only
  collects it; ``speculative_tokens_per_s`` changes no output, whether its
  prefix holds every segment or not, and agrees with the JAX ``Segmenter``
  given the same option.
"""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import sylber_tpu_torch.api as api
from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.serve import SegmenterServer
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"


class FakeSegmenter:
    """Deterministic pure-numpy stand-in recording batch compositions."""

    batch_buckets = (1, 2, 4, 8)

    def __init__(self, delay_s=0.0, fail_on=None):
        self.batches = []
        self.delay_s = delay_s
        self.fail_on = fail_on  # wav length that raises
        self.lock = threading.Lock()

    def process(self, wavs, in_second=True, norm_threshold=None,
                merge_threshold=None, return_hidden=True):
        with self.lock:
            self.batches.append(len(wavs))
        if self.delay_s:
            time.sleep(self.delay_s)
        outs = []
        for w in wavs:
            if self.fail_on is not None and len(w) == self.fail_on:
                raise RuntimeError("boom")
            n = len(w)
            seg = np.array([[0, n]], float)
            outs.append({
                "segments": seg / 50.0 if in_second else seg,
                # fingerprint of the exact wav and options: proves routing
                "segment_features": np.array([
                    [float(w.sum()), float(n),
                     -1.0 if norm_threshold is None else norm_threshold,
                     -1.0 if merge_threshold is None else merge_threshold]]),
                "frame_norms": np.zeros(4),
            })
        return outs


def wavs_for(n, rng, lo=4000, hi=12000):
    return [rng.randn(rng.randint(lo, hi)).astype(np.float32) for _ in range(n)]


# ---- batching mechanics (fake segmenter) --------------------------------

def test_concurrent_submissions_batch_and_route_exactly():
    fake = FakeSegmenter(delay_s=0.01)
    wavs = wavs_for(24, np.random.RandomState(1))
    with SegmenterServer(fake, max_batch=8, max_wait_ms=40.0) as srv:
        futs = [None] * len(wavs)

        def client(i):
            futs[i] = srv.submit(wavs[i], norm_threshold=1.5)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        outs = [f.result(timeout=60) for f in futs]
        st = srv.stats()
    for w, o in zip(wavs, outs):
        np.testing.assert_allclose(o["segment_features"][0], [w.sum(), len(w), 1.5, -1.0],
                                   rtol=1e-6)
    assert st.completed == len(wavs)
    assert st.batches < st.requests
    assert 1 < max(fake.batches) <= 8
    assert st.mean_batch_size > 1.0
    assert st.latency_p95_ms > 0.0


def test_incompatible_options_do_not_mix():
    fake = FakeSegmenter(delay_s=0.01)
    w = wavs_for(1, np.random.RandomState(2))[0]
    with SegmenterServer(fake, max_wait_ms=50.0) as srv:
        fa = srv.submit(w, merge_threshold=0.3)
        fb = srv.submit(w, merge_threshold=0.95)
        a, b = fa.result(60), fb.result(60)
    assert a["segment_features"][0][3] == 0.3
    assert b["segment_features"][0][3] == 0.95
    assert fake.batches.count(2) == 0


def test_failed_batch_fails_only_its_requests():
    rng = np.random.RandomState(3)
    good = wavs_for(3, rng, lo=4000, hi=5000)
    bad = rng.randn(7777).astype(np.float32)
    fake = FakeSegmenter(fail_on=7777)
    with SegmenterServer(fake, max_batch=2, max_wait_ms=5.0) as srv:
        fb = srv.submit(bad, norm_threshold=9.0)  # its own key, its own batch
        fgs = [srv.submit(w) for w in good]
        with pytest.raises(RuntimeError, match="boom"):
            fb.result(60)
        for f in fgs:
            assert f.result(60) is not None
        st = srv.stats()
    assert st.failed == 1 and st.completed == 3


def test_stop_drains_queue():
    fake = FakeSegmenter(delay_s=0.02)
    wavs = wavs_for(6, np.random.RandomState(4))
    srv = SegmenterServer(fake, max_batch=4, max_wait_ms=200.0)
    futs = [srv.submit(w) for w in wavs]
    srv.stop(drain=True)
    for f in futs:
        assert f.result(timeout=60) is not None
    with pytest.raises(RuntimeError):
        srv.submit(wavs[0])


def test_bad_request_rejected_eagerly():
    with SegmenterServer(FakeSegmenter(), max_wait_ms=1.0) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros(10, np.float32))  # under one receptive field
        assert srv.segment(np.zeros(4000, np.float32)) is not None


def test_latency_bounded_at_low_load():
    """A lone request does not wait for a full batch."""
    with SegmenterServer(FakeSegmenter(), max_batch=8, max_wait_ms=20.0) as srv:
        t0 = time.monotonic()
        srv.segment(np.zeros(4000, np.float32))
        dt_ms = (time.monotonic() - t0) * 1e3
    assert dt_ms < 5000.0


def test_pipelined_mode_routes_exactly():
    fake = FakeSegmenter(delay_s=0.005)
    wavs = wavs_for(24, np.random.RandomState(5))
    with SegmenterServer(fake, max_batch=8, max_wait_ms=20.0, pipeline_depth=2) as srv:
        futs = [srv.submit(w, norm_threshold=2.5) for w in wavs]
        outs = [f.result(timeout=60) for f in futs]
        st = srv.stats()
    for w, o in zip(wavs, outs):
        np.testing.assert_allclose(o["segment_features"][0], [w.sum(), len(w), 2.5, -1.0],
                                   rtol=1e-6)
    assert st.completed == len(wavs)

    bad = FakeSegmenter(fail_on=7777)
    with SegmenterServer(bad, max_batch=4, max_wait_ms=5.0, pipeline_depth=1) as srv:
        ok = srv.submit(np.ones(5000, np.float32))
        assert ok.result(timeout=60)["segments"] is not None
        boom = srv.submit(np.ones(7777, np.float32))
        with pytest.raises(RuntimeError):
            boom.result(timeout=60)
        ok2 = srv.submit(np.ones(5000, np.float32))  # keeps serving
        assert ok2.result(timeout=60)["segments"] is not None


# ---- the port's Segmenter -----------------------------------------------

def _mini_config():
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    return meta, hub


def _mini(**kw):
    meta, hub = _mini_config()
    return Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), device="cpu",
                     hubert_config=HubertConfig(**hub), norm_threshold=meta["norm_threshold"],
                     merge_threshold=meta["merge_threshold"], **kw)


def _utterances(seed, lengths_s):
    rng = np.random.RandomState(seed)
    out = []
    for s in lengths_s:
        wav, _ = synth_utterance(rng, int(s * 16000))
        out.append(((wav - wav.mean()) / (wav.std(ddof=1) + 1e-12)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def seg():
    return _mini(length_bucket_s=0.5, batch_buckets=(1, 2, 4, 8))


def _assert_identical(got, want):
    assert got["segments"].tolist() == want["segments"].tolist()
    np.testing.assert_array_equal(got["segment_features"], want["segment_features"])


def test_single_request_matches_direct_bitexact(seg):
    w = _utterances(0, (2.3,))[0]
    direct = seg.process([w], return_hidden=False)[0]
    with SegmenterServer(seg, max_wait_ms=1.0) as srv:
        out = srv.segment(w)
    assert len(out["segments"])
    _assert_identical(out, direct)
    assert "hidden_states" not in out  # serving skips the hidden states


def test_real_batch_matches_direct_batch(seg):
    """The same batch on both sides: identical outputs."""
    wavs = _utterances(7, (1.2, 2.1, 1.7, 2.4))
    direct = seg.process(sorted(wavs, key=len, reverse=True), return_hidden=False)
    with SegmenterServer(seg, max_batch=4, max_wait_ms=500.0) as srv:
        outs = [f.result(60) for f in srv.submit_many(wavs)]
        st = srv.stats()
    assert st.batches == 1  # all four in one batch, longest first
    by_len = {len(w): d for w, d in zip(sorted(wavs, key=len, reverse=True), direct)}
    for w, o in zip(wavs, outs):
        _assert_identical(o, by_len[len(w)])


@pytest.mark.parametrize("depth", [0, 1])
def test_in_second_toggle(seg, depth):
    w = _utterances(5, (1.9,))[0]
    with SegmenterServer(seg, max_wait_ms=1.0, pipeline_depth=depth) as srv:
        sec = srv.segment(w, in_second=True)
        frames = srv.segment(w, in_second=False)
    assert len(frames["segments"])
    np.testing.assert_allclose(np.asarray(sec["segments"]) * 50.0,
                               np.asarray(frames["segments"]), atol=1e-6)


def test_finalize_holds_every_host_wait(seg, monkeypatch):
    """``process_async`` enqueues the forward and the segmentation; the
    returned ``finalize`` only collects: it runs neither again."""
    calls = []
    real_segment_batch, real_forward = api.segment_batch, seg._forward_segment
    monkeypatch.setattr(api, "segment_batch",
                        lambda *a, **k: calls.append("segment_batch") or real_segment_batch(*a, **k))
    monkeypatch.setattr(seg, "_forward_segment",
                        lambda *a, **k: calls.append("forward") or real_forward(*a, **k))
    finalize = seg.process_async(_utterances(3, (1.4, 2.2)), return_hidden=False)
    assert calls == ["forward", "segment_batch"]
    outs = finalize()
    assert calls == ["forward", "segment_batch"] and len(outs) == 2


@pytest.fixture(scope="module")
def spec_wavs():
    return _utterances(11, (3.0, 11.5, 7.2))


@pytest.mark.parametrize("rate", [6.0, 0.01], ids=["prefix_holds", "prefix_short"])
def test_speculative_prefix_changes_nothing(spec_wavs, rate):
    """At 6 tokens a second the prefix holds every segment of the batch; at
    0.01 (9 rows) it does not and the sliced fetch runs."""
    plain = _mini()
    spec = _mini(speculative_tokens_per_s=rate)
    assert spec.speculative_tokens_per_s == rate
    want = plain.process(spec_wavs, return_hidden=False)
    got = spec.process(spec_wavs, return_hidden=False)
    kmax = max(len(o["segments"]) for o in want)
    k = int(np.ceil(12.0 * rate)) + 8  # the 12 s bucket
    assert (kmax <= k) == (rate == 6.0), (kmax, k)
    for g, w in zip(got, want):
        _assert_identical(g, w)


def test_speculative_prefix_agrees_with_jax(spec_wavs):
    meta, hub = _mini_config()
    jax_seg = JaxSegmenter(params=load_params_npz(str(FIXTURES / "mini_ckpt.npz")),
                           hubert_config=JaxConfig(**hub), speculative_tokens_per_s=6.0,
                           norm_threshold=meta["norm_threshold"],
                           merge_threshold=meta["merge_threshold"])
    want = jax_seg.process(spec_wavs, return_hidden=False)
    got = _mini(speculative_tokens_per_s=6.0).process(spec_wavs, return_hidden=False)
    for g, w in zip(got, want):
        assert g["segments"].tolist() == w["segments"].tolist()
        np.testing.assert_allclose(g["segment_features"], w["segment_features"],
                                   atol=2e-4, rtol=0)


def test_matmul_precision_flags_hold_across_threads():
    """A server's dispatcher runs the encoder (TF32 on in fast mode) while
    request threads run the quantizer's matmul (TF32 off): each thread must
    see its own setting for the whole block, and the flags end as they began."""
    import sys

    import torch

    from sylber_tpu_torch.models.hubert import matmul_precision

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    before, wrong = flags(), []

    def worker(i):
        precision = "highest" if i % 2 else "default"
        for _ in range(200):
            with matmul_precision(precision):
                want = (precision != "highest",) * 2
                time.sleep(0)
                if flags() != want:
                    wrong.append((i, flags()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not wrong, wrong[:5]
    assert flags() == before
