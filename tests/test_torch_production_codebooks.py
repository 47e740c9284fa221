"""The production codebooks' pieces (``sylber_tpu_torch/production_codebooks.py``)
against ``scripts/production_codebooks.py`` on the CPU.

- ``ridge_r`` on seeded data: within 1e-6 of the script's;
- ``quantization_stats`` (tokens 16,384 rows at a time, usage over every
  row, the SNR) against the script's lines 175-184 through JAX's
  ``KMQuantizer``: the same tokens and usage, the SNR within 1e-6;
- the vocoder proof's ``build_corpus`` on 4 continuum crops: arrays equal
  to the script's (``train_vocoder_proof.py``);
- ``collect_features_with_truth`` on 4 continuum utterances (batch 2, chunks
  of 3, so a chunk ends inside a batch): the per-segment pitch and voiced
  fraction equal to the script's, the features within 1e-4 (the script
  jits its encoder and segmentation).
"""

import numpy as np
import pytest
import torch

from _torch_proof_helpers import jax_synth
from sylber_tpu.flow.quantizer import KMQuantizer as JaxKMQuantizer
from sylber_tpu_torch import production_codebooks as pc
from sylber_tpu_torch import token_chain_proof as tcp
from sylber_tpu_torch import vocoder_proof as vp
from sylber_tpu_torch.quantizer import KMQuantizer

import production_codebooks as jax_pc  # noqa: E402  (scripts/, on the path by the helpers)
import train_vocoder_proof as jax_vp  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ridge_r_matches_the_script(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(400, 24).astype(np.float32)
    y = (x[:, :3] @ rng.randn(3) + 0.3 * rng.randn(400)).astype(np.float32)
    for lam in (1.0, 10.0):
        got, want = pc.ridge_r(x, y, lam=lam, seed=seed), jax_pc.ridge_r(x, y, lam=lam, seed=seed)
        assert abs(got - want) <= 1e-6, (got, want)


def test_quantization_stats_match_the_script():
    """Rows past one 16,384-row block; a codebook some rows never pick."""
    rng = np.random.RandomState(4)
    feats = rng.randn(20000, 12).astype(np.float32)
    cents = np.concatenate([feats[:200] + 0.01 * rng.randn(200, 12).astype(np.float32),
                            rng.randn(56, 12).astype(np.float32) + 40.0])
    toks, quant, usage, snr = pc.quantization_stats(KMQuantizer(cents, device="cpu"), feats)
    q = JaxKMQuantizer(cents)
    want_toks = np.concatenate([np.asarray(q.get_indices(feats[i: i + 16384]))
                                for i in range(0, len(feats), 16384)])
    want_quant = np.asarray(q.decode(want_toks))
    want_snr = 10.0 * np.log10((feats ** 2).sum(-1).mean()
                               / (((feats - want_quant) ** 2).sum(-1).mean() + 1e-12))
    np.testing.assert_array_equal(toks, want_toks)
    np.testing.assert_array_equal(quant, want_quant)
    assert usage == len(np.unique(want_toks)) < len(cents)
    assert abs(snr - float(want_snr)) <= 1e-6 * abs(float(want_snr))


def test_continuum_crops_match_the_script():
    got, want = vp.build_corpus(4, seed=11, style="continuum"), \
        jax_vp.build_corpus(4, seed=11, style="continuum")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_collect_features_with_truth_matches_the_script():
    torch.set_num_threads(2)
    nt, mt = tcp.mini_thresholds()
    jsynth = jax_synth("sylber_resynthesis_rich_mini.yaml", "mini_synth_rich.npz")
    want = jax_pc.collect_features_with_truth(jsynth, nt, mt, n_utts=4, seconds=3.0, seed=5,
                                              batch=2, chunk_utts=3)
    synth, _, _ = tcp.build_synth(style="rich", device="cpu")
    got = pc.collect_features_with_truth(synth, nt, mt, n_utts=4, seconds=3.0, seed=5, batch=2,
                                         chunk_utts=3)
    assert got[0].shape == want[0].shape and len(got[0]) > 20
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
