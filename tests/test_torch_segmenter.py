"""The port's ``Segmenter`` against ``sylber_tpu.api.Segmenter``.

On the trained fixtures (``mini_ckpt.npz``, ``mini_ckpt_rich.npz``), fp32
parity mode: identical segments on ``speechlike.wav`` and on a padded batch
of three seeded utterances of different lengths, features and hidden states
within 2e-4, and batched output equal to single-item output. The three
utterances share one length bucket: the GroupNorm of frontend layer 0 takes
its moments over the padded length, so only then are the two comparable.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models.hubert import HubertConfig as JaxConfig
from sylber_tpu.utils.metrics import boundary_f1 as jax_boundary_f1
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.utils.metrics import boundary_f1
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
WAV = FIXTURES / "speechlike.wav"


def _utterances(seed=9999, lengths_s=(2.9, 2.1, 2.45)):
    rng = np.random.RandomState(seed)
    wavs = []
    for s in lengths_s:
        wav, _ = synth_utterance(rng, int(s * 16000))
        wavs.append(((wav - wav.mean()) / (wav.std(ddof=1) + 1e-12)).astype(np.float32))
    return wavs


def _pair(name):
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    params = jax_load_npz(str(FIXTURES / f"{name}.npz"))
    kw = dict(norm_threshold=meta["norm_threshold"],
              merge_threshold=meta["merge_threshold"])
    jax_seg = JaxSegmenter(params=params, hubert_config=JaxConfig(**hub), **kw)
    port = Segmenter(model_ckpt=str(FIXTURES / f"{name}.npz"),
                     hubert_config=HubertConfig(**hub), device="cpu", **kw)
    return jax_seg, port


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["segments"].tolist() == w["segments"].tolist()
        assert len(g["segments"]) > 0
        np.testing.assert_allclose(g["segment_features"], w["segment_features"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(g["hidden_states"], w["hidden_states"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(g["frame_norms"], w["frame_norms"],
                                   atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["mini_ckpt", "mini_ckpt_rich"])
def test_segmenter_matches_jax_on_trained_fixture(name):
    jax_seg, port = _pair(name)
    _assert_same([port(wav_file=str(WAV), in_second=False)],
                 [jax_seg(wav_file=str(WAV), in_second=False)])

    wavs = _utterances()
    batched = port(wav=wavs, in_second=False)
    _assert_same(batched, jax_seg(wav=wavs, in_second=False))
    for w, b in zip(wavs, batched):  # batched == single
        single = port(wav=w, in_second=False)
        assert single["segments"].tolist() == b["segments"].tolist()
        np.testing.assert_allclose(single["segment_features"], b["segment_features"],
                                   atol=2e-4, rtol=0)


def test_fast_vs_exact_boundary_agreement():
    """The bf16 fast mode reproduces the fp32 parity mode's segment decisions
    on held-out utterances: boundary F1 at tol 0 >= 0.995, the gate the JAX
    package holds its own fast mode to. The port's boundary_f1 is its own
    copy and must agree with the JAX package's."""
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    kw = dict(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), device="cpu",
              norm_threshold=meta["norm_threshold"],
              merge_threshold=meta["merge_threshold"])
    exact = Segmenter(hubert_config=HubertConfig(**hub), **kw)
    fast = Segmenter(hubert_config=HubertConfig(
        dtype="bfloat16", frontend_dtype="bfloat16", precision="default", **hub), **kw)
    rng = np.random.RandomState(9999)
    wavs = _utterances(lengths_s=tuple(rng.uniform(3.0, 8.0, 16)))
    out_e = exact.process(wavs, in_second=False, return_hidden=False)
    out_f = fast.process(wavs, in_second=False, return_hidden=False)
    pairs = [(f["segments"], e["segments"]) for f, e in zip(out_f, out_e)]
    assert all(len(e) for _, e in pairs)
    f1 = [boundary_f1(f, e, tol_frames=0) for f, e in pairs]
    assert f1 == pytest.approx([jax_boundary_f1(f, e, tol_frames=0) for f, e in pairs])
    nseg_delta = np.mean([abs(len(f) - len(e)) for f, e in pairs])
    assert np.mean(f1) >= 0.995, (np.mean(f1), nseg_delta)
    assert nseg_delta <= 0.25, nseg_delta


@pytest.mark.parametrize("pred,ref,tol,want", [
    ([[0, 4], [6, 9]], [[0, 4], [6, 9]], 0, 1.0),
    ([[0, 4], [6, 9]], [[0, 5], [6, 9]], 0, 0.75),
    ([[0, 4], [6, 9]], [[0, 5], [6, 9]], 1, 1.0),
    (np.zeros((0, 2)), np.zeros((0, 2)), 0, 1.0),
    ([[1, 3]], np.zeros((0, 2)), 0, 0.0),
])
def test_boundary_f1_matches_jax_package(pred, ref, tol, want):
    got = boundary_f1(np.asarray(pred), np.asarray(ref), tol_frames=tol)
    assert got == pytest.approx(want)
    assert got == pytest.approx(jax_boundary_f1(np.asarray(pred), np.asarray(ref),
                                                tol_frames=tol))


def test_output_contract():
    """in_second, return_hidden False / "device", empty segment_features, and
    the on-device int16 normalisation."""
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    seg = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"),
                    hubert_config=HubertConfig(num_hidden_layers=2, **hub),
                    norm_threshold=meta["norm_threshold"], device="cpu")
    wav = _utterances(lengths_s=(1.1,))[0]
    out = seg.process([wav], in_second=False, return_hidden=False)
    assert "hidden_states" not in out[0] and len(out[0]["segments"])
    none = seg.process([wav], norm_threshold=1e9)[0]  # no frame is voiced
    assert none["segment_features"].shape == (0,)
    assert none["segments"].shape == (0, 2)
    secs = seg(wav=wav, in_second=True)
    np.testing.assert_allclose(secs["segments"], out[0]["segments"] / 50.0)
    dev = seg.process([wav], return_hidden="device")[0]
    assert isinstance(dev["hidden_states_device"], torch.Tensor)
    np.testing.assert_array_equal(
        dev["hidden_states_device"][:dev["num_frames"]].numpy(), secs["hidden_states"])

    # int16 PCM is normalised on the device over the attended samples
    pcm = np.zeros((2, 32000), np.int16)
    mask = np.zeros((2, 32000), np.int32)
    pcm[0, :20000] = (np.random.RandomState(5).randn(20000) * 3000).astype(np.int16)
    mask[0, :20000] = 1
    x = pcm[0, :20000].astype(np.float64)
    norm = np.zeros((2, 32000), np.float32)
    norm[0, :20000] = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
    h16, r16 = seg._forward_segment(torch.from_numpy(pcm), torch.from_numpy(mask), 3.3, 0.8)
    h32, r32 = seg._forward_segment(torch.from_numpy(norm), torch.from_numpy(mask), 3.3, 0.8)
    np.testing.assert_allclose(h16[0].numpy(), h32[0].numpy(), atol=2e-4, rtol=0)
    assert torch.equal(r16.segments[0], r32.segments[0])


def test_entry_points_need_a_device_choice_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmenter(hubert_config=HubertConfig(
            hidden_size=16, num_attention_heads=2, intermediate_size=32,
            conv_dim=(8,) * 7, num_conv_pos_embeddings=4,
            num_conv_pos_embedding_groups=2, num_hidden_layers=1))
    with pytest.raises(ValueError, match="replicas"):  # not a mesh of replicas
        Segmenter(mesh=object(), device="cpu")
