"""The pitch chain proof (``sylber_tpu_torch/pitch_chain_proof.py``) against
``scripts/pitch_chain_proof.py`` on the CPU.

The fully discrete row, ``km1024+p64``: the explicit-pitch
``mini_synth_rich_pitch`` CFM over the mini encoder, the
``mini_codebook_rich_1024.npy`` art tokens and 64-bin scalar pitch tokens,
on 2 rich held-out utterances of 3 s (seed 90001) at 8 ODE steps, batch 2,
through the script's ``eval_chain`` (which ``pitch_chain_proof`` imports
from ``token_chain_proof``) and the port's: art within 1e-2 of the largest
and every metric within 1e-2; then the vocoder leg on the script's art
through ``mini_vocoder_rich`` (f0_corr within 1e-2, JAX's noise passed to
the port). One JAX run serves the file (``_torch_proof_helpers``).
"""

import numpy as np
import pytest

from _torch_proof_helpers import FIXTURES, jax_noise, jax_synth, jitted_chain_ops, rel_err
from sylber_tpu.flow.quantizer import KMQuantizer as JaxKMQuantizer
from sylber_tpu.flow.quantizer import ScalarPitchQuantizer as JaxPitchQuantizer
from sylber_tpu.train.synthesis_loop import build_synthesis_corpus as jax_corpus
from sylber_tpu_torch import pitch_chain_proof as pcp
from sylber_tpu_torch import token_chain_proof as tcp
from sylber_tpu_torch.flow.quantizer import ScalarPitchQuantizer
from sylber_tpu_torch.quantizer import KMQuantizer

import pitch_chain_proof as jax_pcp  # noqa: E402  (scripts/, on the path by the helpers)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

CODEBOOK = np.load(FIXTURES / pcp.ART_CODEBOOK).astype(np.float32)
STEPS, UTTS, SECONDS, BINS = 8, 2, 3.0, 64


@pytest.fixture(scope="module")
def row():
    heldout = jax_corpus(UTTS, SECONDS, seed=90001, style="rich")
    nt, mt = tcp.mini_thresholds()
    jsynth = jax_synth("sylber_resynthesis_rich_pitch_mini.yaml", "mini_synth_rich_pitch.npz",
                       quantizer=JaxKMQuantizer(CODEBOOK),
                       pitch_quantizer=JaxPitchQuantizer(BINS))
    with jitted_chain_ops():
        want_art, want = jax_pcp.eval_chain(jsynth, nt, mt, heldout, steps=STEPS, batch=UTTS)
    synth, _, _ = pcp.build_pitch_synth(quantizer=KMQuantizer(CODEBOOK, device="cpu"),
                                        pitch_quantizer=ScalarPitchQuantizer(BINS),
                                        device="cpu")
    got_art, got = pcp.eval_chain(synth, nt, mt, heldout, steps=STEPS, batch=UTTS)
    return dict(heldout=heldout, want_art=want_art, want=want, got_art=got_art, got=got)


def test_the_fully_discrete_row_matches_the_script(row):
    assert row["got_art"].shape == row["want_art"].shape
    err = rel_err(row["got_art"], row["want_art"])
    assert err <= 1e-2, err
    assert set(row["got"]) == set(row["want"])
    for k, v in row["want"].items():
        assert abs(row["got"][k] - v) <= 1e-2, (k, row["got"][k], v)


def test_its_vocoder_leg_matches_the_script(row):
    art, heldout = row["want_art"], row["heldout"]
    want = jax_pcp.vocoder_leg(art, heldout, "mini_vocoder_rich")
    got = tcp.vocoder_leg(art, heldout, "mini_vocoder_rich", device="cpu",
                          noise=jax_noise((len(art), art.shape[1] * 320)))
    assert got["n_utts"] == want["n_utts"]
    assert abs(got["f0_corr"] - want["f0_corr"]) <= 1e-2, (got, want)
    assert abs(got["periodicity"] - want["periodicity"]) <= 1e-2, (got, want)
