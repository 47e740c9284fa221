"""``python -m sylber_tpu_torch.parity_vs_reference`` on the CPU.

A random HF ``HubertModel`` of HuBERT base's widths (``torch.manual_seed(0)``;
2 layers, ``--num-hidden-layers 2`` on both sides, so that the file keeps
under 30 s on one worker) saved as a bare state dict: the entry point
prints "PARITY OK" on
``speechlike.wav`` and exits 0 (exact segments, hidden states within its
1e-3 of HF's); the JAX package's ``Segmenter`` on the same checkpoint and
the same unpadded utterance gives the port's segments exactly and its
hidden states within 2e-4; a checkpoint perturbed on the port's side alone
prints "PARITY MISMATCH" and exits 1.
"""

import json
import os

import numpy as np
import pytest
import torch

from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu_torch import parity_vs_reference as pvr
from sylber_tpu_torch.utils.audio import load_for_inference

WAV = pvr.ROOT / "tests" / "fixtures" / "speechlike.wav"
LAYERS = 2


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    os.environ.setdefault("USE_TF", "0")  # as the entry point imports it: PyTorch models alone
    pytest.importorskip("transformers")
    from transformers import HubertConfig, HubertModel

    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("parity") / "hubert.pt"
    torch.save(HubertModel(HubertConfig(num_hidden_layers=LAYERS)).state_dict(), path)
    return path


def test_parity_ok_against_hf_and_jax(checkpoint, tmp_path, capsys):
    assert pvr.main(["--ckpt", str(checkpoint), "--num-hidden-layers", str(LAYERS),
                     "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "PARITY OK"
    rep = json.loads((tmp_path / "parity_vs_reference.json").read_text())
    assert rep["ok"] and rep["segments_exact"] and rep["frames"] == 24
    assert rep["hidden_states_max_abs_delta"] < 1e-3

    wav = load_for_inference(WAV)
    got = pvr.port_pipeline(str(checkpoint), wav, 2.6, 0.8, "cpu", LAYERS)
    want = JaxSegmenter(model_ckpt=str(checkpoint), encoding_layer=LAYERS, precision="highest",
                        length_bucket_s=(len(wav) + 0.5) / 16000)(
        wav=wav, in_second=False, norm_threshold=2.6, merge_threshold=0.8)
    np.testing.assert_array_equal(got["segments"], np.asarray(want["segments"]))
    np.testing.assert_allclose(got["hidden_states"], np.asarray(want["hidden_states"]),
                               rtol=0, atol=2e-4)


def test_perturbed_checkpoint_is_a_mismatch(checkpoint, tmp_path, monkeypatch, capsys):
    sd = torch.load(checkpoint)
    w = sd["feature_projection.projection.weight"]  # random init: std 0.02
    w += 0.02 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1))
    bad = tmp_path / "perturbed.pt"
    torch.save(sd, bad)
    ref = pvr.ref_pipeline
    monkeypatch.setattr(pvr, "ref_pipeline", lambda ckpt, *a, **k: ref(str(checkpoint), *a, **k))
    assert pvr.main(["--ckpt", str(bad), "--num-hidden-layers", str(LAYERS), "--device", "cpu",
                     "--out-dir", str(tmp_path)]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "PARITY MISMATCH"
    rep = json.loads((tmp_path / "parity_vs_reference.json").read_text())
    assert not rep["ok"] and rep["hidden_states_max_abs_delta"] >= 1e-3
