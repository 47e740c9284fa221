"""The port's ``LongFormSegmenter`` against ``sylber_tpu.longform``.

On the trained ``mini_ckpt.npz`` (144 wide, 9 layers) in fp32 parity mode,
a 24 s synthetic utterance cut into 10 s windows with 2 s of overlap:

- float32 windows: segments identical to the JAX package, segment
  features and the stitched hidden track within 2e-4;
- the resident int16 path: segments identical to the JAX package's resident
  path, features within 2e-4, and boundary F1 at tolerance 0 against the
  float32 path >= 0.995 (the JAX package's ``longform_int16_vs_f32_f1`` gate);
- long-form against the direct pass over the whole utterance: F1 >= 0.85 at
  tolerance 1, the JAX package's gate.

The stitching helpers are also fed the same window results as the JAX
helpers, built from one shared states track (no encoder): cuts and stitched
spans equal, and the fast features equal to pooling the stitched track.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.longform import LongFormSegmenter as JaxLongForm
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu.ops.segment_np import segment_oracle
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.longform import LongFormSegmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.utils.metrics import boundary_f1

FIXTURES = Path(__file__).parent / "fixtures"
LF = dict(chunk_seconds=10.0, overlap_seconds=2.0)


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


@pytest.fixture(scope="module")
def runs(mini):
    """Each long-form configuration once on each side, on one utterance."""
    jax_seg, port = mini
    wav = _utterance(777, 24.0)
    out = {}
    for transfer, hidden in (("float32", True), ("float32", False), ("int16", False)):
        call = dict(wav=wav, in_second=False, return_hidden=hidden)
        out[transfer, hidden] = (JaxLongForm(jax_seg, transfer=transfer, **LF)(**call),
                                 LongFormSegmenter(port, transfer=transfer, **LF)(**call))
    return wav, out


@pytest.mark.parametrize("transfer,hidden", [("float32", True), ("float32", False),
                                             ("int16", False)])
def test_longform_matches_jax(runs, transfer, hidden):
    _, out = runs
    want, got = out[transfer, hidden]
    assert len(got["segments"]) > 20
    assert got["segments"].tolist() == want["segments"].tolist()
    np.testing.assert_allclose(got["segment_features"], want["segment_features"],
                               atol=2e-4, rtol=0)
    assert ("hidden_states" in got) == hidden
    if hidden:
        assert got["hidden_states"].shape == want["hidden_states"].shape
        np.testing.assert_allclose(got["hidden_states"], want["hidden_states"],
                                   atol=2e-4, rtol=0)


def test_resident_int16_agrees_with_float32_windows(runs):
    _, out = runs
    f32, i16 = out["float32", False][1], out["int16", False][1]
    f1 = boundary_f1(i16["segments"], f32["segments"], tol_frames=0)
    assert f1 >= 0.995, f1
    assert abs(int(i16["segments"][-1][1]) - int(f32["segments"][-1][1])) <= 2


def test_longform_matches_direct(mini, runs):
    _, port = mini
    wav, out = runs
    direct = port.process([wav], in_second=False, return_hidden=False)[0]
    f1 = boundary_f1(out["float32", False][1]["segments"], direct["segments"], tol_frames=1)
    assert f1 >= 0.85, f1
    assert port.mesh is None


def test_short_tail_window_and_padded_batches(mini):
    """A wav that is no whole number of frames, a last window shorter than
    the chunk, and three window batches of two, the last one padded: the
    resident path equals the JAX package's."""
    jax_seg, port = mini
    wav = _utterance(9, 9.0)
    wav = np.concatenate([wav, wav[:137]])
    kw = dict(chunk_seconds=4.0, overlap_seconds=1.0, batch_windows=2)
    call = dict(wav=wav, in_second=False, return_hidden=False)
    want = JaxLongForm(jax_seg, **kw)(**call)
    got = LongFormSegmenter(port, **kw)(**call)
    segs = got["segments"]
    assert len(segs) and (segs[:, 1] > segs[:, 0]).all()
    assert segs[-1][1] <= len(wav) // 320
    assert segs.tolist() == want["segments"].tolist()
    np.testing.assert_allclose(got["segment_features"], want["segment_features"],
                               atol=2e-4, rtol=0)


# ---- stitching on a shared states track --------------------------------

class _WindowsOfOneTrack:
    """Serves windows of one precomputed states track, segmented by the
    oracle, so the stitching can be held against the full track."""

    def __init__(self, states, as_tensor):
        self.states, self.as_tensor = states, as_tensor

    def process(self, windows, **_):
        outs = []
        for lo, n in windows:
            st = self.states[lo: lo + n]
            segs = segment_oracle(st, 2.0, 0.8)
            outs.append({
                "segments": segs,
                "hidden_states": st,
                "hidden_states_device": torch.from_numpy(st) if self.as_tensor else st,
                "frame_norms": np.sqrt((st ** 2).sum(-1) + 1e-8),
                "segment_features": (np.stack([st[s:e].mean(0) for s, e in segs])
                                     if len(segs) else np.array([])),
            })
        return outs


def _track(rng, L, gaps, d=32):
    """Plateaus of 3-14 frames; a share ``gaps`` of them are low-norm gaps."""
    states = np.zeros((L, d), np.float32)
    i = 0
    while i < L:
        span = min(int(rng.randint(3, 15)), L - i)
        if rng.rand() < gaps:
            states[i:i + span] = rng.randn(span, d) * 0.05
        else:
            proto = rng.randn(d)
            states[i:i + span] = (proto / np.linalg.norm(proto) * rng.uniform(4, 9)
                                  + rng.randn(span, d) * 0.1)
        i += span
    return states


def _stitch(cls, states, chunk, overlap, as_tensor):
    lf = cls.__new__(cls)
    lf.segmenter = _WindowsOfOneTrack(states, as_tensor)
    lf.chunk_frames, lf.overlap_frames, lf.batch_windows = chunk, overlap, 4
    starts = list(range(0, max(len(states) - overlap, 1), chunk - overlap))
    results = lf.segmenter.process([(s, min(chunk, len(states) - s)) for s in starts])
    cuts = lf._cuts(starts, results)
    stitched = lf._stitch_segments(starts, results, cuts)
    hidden = lf._stitch_hidden(starts, results, cuts)
    return lf, starts, results, cuts, stitched, hidden


@pytest.mark.parametrize("seed,L,chunk,overlap,gaps", [(0, 900, 300, 60, 0.3),
                                                       (3, 700, 250, 50, 0.0)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "tensor"])
def test_stitching_matches_jax_on_shared_states(seed, L, chunk, overlap, gaps, as_tensor):
    """Without gaps the cuts fall inside segments, which are pooled again."""
    states = _track(np.random.RandomState(seed), L, gaps)
    jax_lf, j_starts, j_results, j_cuts, j_stitched, j_hidden = _stitch(
        JaxLongForm, states, chunk, overlap, False)
    lf, starts, results, cuts, stitched, hidden = _stitch(
        LongFormSegmenter, states, chunk, overlap, as_tensor)
    assert cuts == j_cuts
    assert stitched == j_stitched
    assert any(t for *_, t in stitched) == (gaps == 0.0)
    np.testing.assert_array_equal(hidden, states)
    fast = lf._features_fast(starts, results, stitched)
    full = np.stack([hidden[s:e].mean(0) for _, s, e, _ in stitched])
    np.testing.assert_allclose(fast, full, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fast, jax_lf._features_fast(j_starts, j_results, j_stitched),
                               atol=1e-5, rtol=1e-5)


def test_batched_repool_pads_ragged_windows():
    """Windows of different padded lengths (the float path's last batch)
    pool as the plain mean of each span."""
    rng = np.random.RandomState(4)
    hs = [torch.from_numpy(rng.randn(n, 8).astype(np.float32)) for n in (50, 37, 50)]
    spans = [(0, 0, 3, 20), (1, 1, 30, 37), (2, 2, 0, 50)]
    got = LongFormSegmenter._batched_repool(hs, spans)
    want = np.stack([hs[w][a:b].numpy().mean(0) for _, w, a, b in spans])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
