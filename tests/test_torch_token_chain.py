"""The token chain proof (``sylber_tpu_torch/token_chain_proof.py``) against
``scripts/token_chain_proof.py`` on the CPU.

On the trained mini fixtures with the checked-in ``mini_codebook_256.npy``,
2 held-out utterances of 3 s (seed 90001), 8 ODE steps, batch 2, as
``tests/parity/test_token_resynthesis.py``'s live chain runs it: the script's
``eval_chain`` against the port's (the same token ids, art within 1e-2 of
the largest, every metric within 1e-2), then the script's ``vocoder_leg``
against the port's on the script's art (f0_corr within 1e-2, JAX's noise
draw passed to the port). The JAX synthesis is built with its weights
(``build_synth`` would first run a discarded eager random init, 20 s) and
its encoder's ``apply`` jitted (eager, its op-by-op compile dominates); one
JAX run serves the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_proof_helpers import FIXTURES, jax_noise, jax_synth, jitted_chain_ops, rel_err
from sylber_tpu.flow.quantizer import KMQuantizer as JaxKMQuantizer
from sylber_tpu.train.synthesis_loop import build_synthesis_corpus as jax_corpus
from sylber_tpu_torch import token_chain_proof as tcp
from sylber_tpu_torch.quantizer import KMQuantizer

import token_chain_proof as jax_tcp  # noqa: E402  (scripts/, on the path by the helpers)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

CODEBOOK = np.load(FIXTURES / "mini_codebook_256.npy").astype(np.float32)
STEPS, UTTS, SECONDS = 8, 2, 3.0


@pytest.fixture(scope="module")
def chains():
    heldout = jax_corpus(UTTS, SECONDS, seed=90001)
    nt, mt = tcp.mini_thresholds()
    jsynth = jax_synth("sylber_resynthesis_mini.yaml", "mini_synth.npz",
                       quantizer=JaxKMQuantizer(CODEBOOK))
    with jitted_chain_ops():
        want_art, want = jax_tcp.eval_chain(jsynth, nt, mt, heldout, steps=STEPS, batch=UTTS)
    synth, nt2, mt2 = tcp.build_synth(quantizer=KMQuantizer(CODEBOOK, device="cpu"),
                                      device="cpu")
    assert (nt2, mt2) == (nt, mt)
    got_art, got = tcp.eval_chain(synth, nt, mt, heldout, steps=STEPS, batch=UTTS)
    return dict(heldout=heldout, jsynth=jsynth, synth=synth, nt=nt, mt=mt,
                want_art=want_art, want=want, got_art=got_art, got=got)


def test_eval_chain_matches_the_script(chains):
    c = chains
    assert c["got_art"].shape == c["want_art"].shape
    err = rel_err(c["got_art"], c["want_art"])
    assert err <= 1e-2, err
    assert set(c["got"]) == set(c["want"])
    for k, v in c["want"].items():
        assert abs(c["got"][k] - v) <= 1e-2, (k, c["got"][k], v)


def test_the_same_token_ids(chains):
    """The tokens of every segment: the JAX encoder, segmentation and
    quantizer against the port's on the held-out audio."""
    from sylber_tpu.ops.segment import segment_batch as jax_segment_batch

    c = chains
    wav = c["heldout"]["wav"]
    hidden = c["jsynth"].hubert.apply({"params": c["jsynth"].params.hubert}, jnp.asarray(wav),
                                      None).astype(jnp.float32)
    res = jax.jit(jax_segment_batch)(hidden, c["nt"], c["mt"])
    want = np.asarray(c["jsynth"].quantizer.get_indices(res.features))
    f, _, k = tcp.segment_features(c["synth"], wav, c["nt"], c["mt"])
    got = c["synth"].quantizer.get_indices(f).numpy()
    assert np.array_equal(k, np.asarray(res.num_segments))
    for j in range(len(k)):
        np.testing.assert_array_equal(got[j, : k[j]], want[j, : k[j]])


def test_vocoder_leg_matches_the_script(chains):
    c = chains
    art, heldout = c["want_art"], c["heldout"]
    want = jax_tcp.vocoder_leg(art, heldout)
    got = tcp.vocoder_leg(art, heldout, device="cpu",
                          noise=jax_noise((len(art), art.shape[1] * 320)))
    assert got["n_utts"] == want["n_utts"]
    assert abs(got["f0_corr"] - want["f0_corr"]) <= 1e-2, (got, want)
    assert abs(got["periodicity"] - want["periodicity"]) <= 1e-2, (got, want)
