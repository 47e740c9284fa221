"""The port's pitch-modulation ceiling and pitch decodability probes against
the JAX package on the CPU.

- ``pitch_modulation_ceiling_probe`` at 8 held-out utterances: the trained
  mini encoder's segments equal JAX's (its encoder and ``segment_batch`` in
  batches of 8, as the script runs them), and both ceilings within 1e-6 of
  the script's ``fill_segment_means`` and JAX's metric on the same spans.
- ``pitch_decodability_probe`` at 12 utterances for both encoder fixtures:
  every number of the JAX script's JSON (its ``main``, argv patched, stdout
  parsed) within 1e-4.

``vq_pitch_probe``'s test is ``test_torch_vq_pitch_probe.py``: each file keeps
under 30 s on one worker.
"""

import contextlib
import importlib.util
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sylber_tpu.data.dataset import _zero_mean_unit_var
from sylber_tpu.data.synthetic import synth_utterance
from sylber_tpu.ops.segment import segment_batch
from sylber_tpu.utils.metrics import per_utterance_pitch_modulation
from sylber_tpu_torch import pitch_decodability_probe as dec
from sylber_tpu_torch import pitch_modulation_ceiling_probe as ceiling
from _torch_proof_helpers import FIXTURES, SCRIPTS, jax_synth

R_TOL = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ceiling_probe_matches_jax(tmp_path):
    n_eval = 8
    got = ceiling.main(["--n-eval", str(n_eval), "--device", "cpu",
                        "--out-dir", str(tmp_path)])
    assert json.loads((tmp_path / "pitch_modulation_ceiling_probe.json").read_text())[
        "n_eval_utts"] == n_eval

    script = _script("pitch_modulation_ceiling_probe")
    synth = jax_synth("sylber_resynthesis_rich_mini.yaml", "mini_synth_rich.npz")
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    nt, mt = float(meta["norm_threshold"]), float(meta["merge_threshold"])
    rng = np.random.RandomState(90001)
    wavs, arts, spans = [], [], []
    for _ in range(n_eval):
        wav, segs, art = synth_utterance(rng, 80000, return_art=True, style="rich")
        pad = np.zeros(160, np.float32)
        wavs.append(np.concatenate([pad, _zero_mean_unit_var(wav), pad]))
        arts.append(art)
        spans.append(np.asarray(segs))
    truth = np.stack(arts).astype(np.float32)

    @jax.jit
    def seg(params, w):
        hidden = synth.hubert.module.apply({"params": params}, w, None).astype(jnp.float32)
        res = segment_batch(hidden, nt, mt)
        return res.segments, res.num_segments

    s, k = (np.asarray(x) for x in seg(synth.params.hubert, jnp.asarray(np.stack(wavs))))
    want_segments = [s[j, : int(k[j])] for j in range(n_eval)]
    for a, b in zip(got["segments"], want_segments):
        np.testing.assert_array_equal(a, b)

    def score(fills):
        art = np.zeros(truth.shape, np.float32)
        art[..., 12] = np.stack(fills)
        return per_utterance_pitch_modulation(art, truth)

    model = score([script.fill_segment_means(t[:, 12], t[:, 13], sp)
                   for t, sp in zip(truth, want_segments)])
    oracle = score([script.fill_segment_means(t[:, 12], t[:, 13], sp)
                    for t, sp in zip(truth, spans)])
    assert abs(got["oracle_segment_fill"] - model) <= 1e-6
    assert abs(got["oracle_truth_segments"] - oracle) <= 1e-6


@pytest.mark.parametrize("encoder", ["mini_ckpt.json", "mini_ckpt_rich.json"])
def test_decodability_probe_matches_jax_script(tmp_path, monkeypatch, encoder):
    path = str(FIXTURES / encoder)
    got = dec.main(["--encoder", path, "--n", "12", "--device", "cpu",
                    "--out-dir", str(tmp_path)])
    assert json.loads((tmp_path / "pitch_decodability_probe.json").read_text()) == got
    monkeypatch.setattr(sys, "argv", ["pitch_decodability_probe.py", "--encoder", path,
                                      "--n", "12"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _script("pitch_decodability_probe").main()
    want = json.loads(buf.getvalue())
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert abs(got[key] - value) <= R_TOL, (key, got[key], value)
        else:
            assert got[key] == value, key
