"""The proof modules' gate functions against the JAX package's parity tests.

Each port module carries its own copy of the gates of the parity test that
judges the recorded table (it imports no test file). Here each copy is held
to the parity test's own functions, called directly with a table: on every
recorded table both pass, and on a copy pushed past each single gate both
fail. Tables: ``token_chain.json`` (``test_token_resynthesis.py:41-85``),
``token_chain_rich.json`` (``test_token_chain_rich.py:49-101``),
``token_chain_rich_pitch.json`` (``test_token_chain_pitch.py:118-135``, which
reads its file: the copy is written and the module's path pointed at it),
``token_chain_prod.json`` (``test_token_chain_prod.py:57-117``),
``mini_vocoder.json`` and ``mini_vocoder_rich.json``
(``test_mini_vocoder.py:50-54``, ``test_rich_fixtures.py:187-190``) and
``mini_vq_synth.json``'s eval (``test_token_resynthesis.py:264-266``).
"""

import copy
import importlib.util
import json
from pathlib import Path

import pytest

from sylber_tpu_torch import (pitch_chain_proof, production_codebooks, token_chain_proof,
                              vocoder_proof)
from sylber_tpu_torch.train.vq_synthesis import eval_gate_failures
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

TESTS = Path(__file__).parent
FIXTURES = TESTS / "fixtures"


def _parity(name):
    spec = importlib.util.spec_from_file_location(f"jax_parity_{name}",
                                                  TESTS / "parity" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recorded(name):
    return json.loads((FIXTURES / name).read_text())


def _jax_verdict(checks, arg) -> bool:
    """True when every parity test function passes on ``arg``."""
    try:
        for check in checks:
            check(arg) if arg is not None else check()
    except AssertionError:
        return False
    return True


V1 = _parity("test_token_resynthesis")
RICH = _parity("test_token_chain_rich")
PITCH = _parity("test_token_chain_pitch")
PROD = _parity("test_token_chain_prod")
VOC = _parity("test_mini_vocoder")
RICH_FX = _parity("test_rich_fixtures")


def _set(path, value):
    """A mutation: ``path`` into the table (a callable value takes the table)."""
    def apply(t):
        node = t
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value(t) if callable(value) else value
    return apply


def _feat(key, delta):
    return lambda t: t["table"]["features"][key] + delta


def _base(t):  # mini_vocoder.json's random-init mel L1
    return t["eval_random_init"]["mel_l1"]


TOKEN_V1 = {
    "features pitch_corr": _set(("table", "features", "pitch_corr"), 0.84),
    "features loud_corr": _set(("table", "features", "loud_corr"), 0.74),
    "features pitch_l1_voiced": _set(("table", "features", "pitch_l1_voiced"), 0.16),
    "km256 pitch_corr delta": _set(("table", "km256", "pitch_corr"), _feat("pitch_corr", -0.06)),
    "km256 loud_corr delta": _set(("table", "km256", "loud_corr"), _feat("loud_corr", -0.04)),
    "km1024 pitch_l1 delta": _set(("table", "km1024", "pitch_l1_voiced"),
                                  _feat("pitch_l1_voiced", 0.03)),
    "km1024 loud_l1 delta": _set(("table", "km1024", "loud_l1"), _feat("loud_l1", 0.02)),
    "km64 pitch_corr floor": _set(("table", "km64", "pitch_corr"), 0.59),
    "km64 loud_corr floor": _set(("table", "km64", "loud_corr"), 0.59),
    "km64 usage": _set(("table", "km64", "codebook_usage"), 63),
    "km1024 usage": _set(("table", "km1024", "codebook_usage"), 200),
}
TOKEN_RICH = {
    "features pitch_corr": _set(("table", "features", "pitch_corr"), 0.79),
    "features loud_corr": _set(("table", "features", "loud_corr"), 0.59),
    "km1024 pitch_corr delta": _set(("table", "km1024", "pitch_corr"),
                                    _feat("pitch_corr", -0.09)),
    "km256 loud_corr delta": _set(("table", "km256", "loud_corr"), _feat("loud_corr", -0.06)),
    "km4096 pitch_l1 delta": _set(("table", "km4096", "pitch_l1_voiced"),
                                  _feat("pitch_l1_voiced", 0.05)),
    "km64 pitch_corr floor": _set(("table", "km64", "pitch_corr"), 0.59),
    "km64 loud_corr floor": _set(("table", "km64", "loud_corr"), 0.54),
    "km64 usage": _set(("table", "km64", "codebook_usage"), 63),
    "km256 usage": _set(("table", "km256", "codebook_usage"), 255),
    "km1024 usage": _set(("table", "km1024", "codebook_usage"), 899),
    "km4096 usage": _set(("table", "km4096", "codebook_usage"),
                         lambda t: t["table"]["km1024"]["codebook_usage"]),
    "true_art f0": _set(("table", "true_art", "vocoder", "f0_corr"), 0.89),
    "features pitch_mod_r": _set(("table", "features", "pitch_mod_r"), 0.49),
    "features vocoder f0": _set(("table", "features", "vocoder", "f0_corr"), 0.39),
    "km4096 pitch_mod_r": _set(("table", "km4096", "pitch_mod_r"), 0.44),
    "km256 vocoder f0": _set(("table", "km256", "vocoder", "f0_corr"), 0.39),
}
PITCH_ROWS = {
    "true_art f0": _set(("table", "true_art", "vocoder", "f0_corr"), 0.89),
    "features pitch_mod_r": _set(("table", "features", "pitch_mod_r"), 0.79),
    "features pitch_corr": _set(("table", "features", "pitch_corr"), 0.89),
    "km1024 pitch_mod_r": _set(("table", "km1024", "pitch_mod_r"), 0.74),
    "p64 pitch_mod_r": _set(("table", "km1024+p64", "pitch_mod_r"), 0.74),
    "p64 pitch_l1_voiced": _set(("table", "km1024+p64", "pitch_l1_voiced"), 0.081),
    "p64 vocoder f0": _set(("table", "km1024+p64", "vocoder", "f0_corr"), 0.59),
    "no p row": lambda t: t["table"].pop("km1024+p64"),
}
PROD_ROWS = {
    "segments": _set(("fit_corpus", "n_segments"), 99_999),
    "corpus style": _set(("fit_corpus", "style"), "rich"),
    "usage km5000": _set(("table", "km5000", "codebook_usage"), 4999),
    "usage km10000": _set(("table", "km10000", "codebook_usage"), 6999),
    "usage km20000 floor": _set(("table", "km20000", "codebook_usage"), 6999),
    "usage km20000 vs km10000": _set(("table", "km20000", "codebook_usage"),
                                     lambda t: t["table"]["km10000"]["codebook_usage"] - 501),
    "continuous ridge": _set(("table", "features", "pitch_ridge_r"), 0.89),
    "snr km5000": _set(("table", "km5000", "quant_snr_db"), 24.9),
    "snr km10000": _set(("table", "km10000", "quant_snr_db"), 39.9),
    "inertia order": _set(("table", "km20000", "kmeans_inertia"), 1.0),
    "km10000 ridge": _set(("table", "km10000", "pitch_ridge_r"), 0.92),
    "features pitch_corr": _set(("table", "features", "pitch_corr"), 0.79),
    "features loud_corr": _set(("table", "features", "loud_corr"), 0.69),
    "features pitch_mod_r": _set(("table", "features", "pitch_mod_r"), 0.49),
    "features vocoder f0": _set(("table", "features", "vocoder", "f0_corr"), 0.39),
    "km5000 pitch_corr delta": _set(("table", "km5000", "pitch_corr"),
                                    _feat("pitch_corr", -0.06)),
    "km5000 loud_corr floor": _set(("table", "km5000", "loud_corr"), 0.69),
    "km10000 pitch_l1 delta": _set(("table", "km10000", "pitch_l1_voiced"),
                                   _feat("pitch_l1_voiced", 0.05)),
    "km20000 pitch_mod_r": _set(("table", "km20000", "pitch_mod_r"), 0.44),
    "km5000 vocoder f0": _set(("table", "km5000", "vocoder", "f0_corr"), 0.39),
    "km5000 periodicity": _set(("table", "km5000", "vocoder", "periodicity"), 0.69),
}
VOCODER_V1 = {
    "mel_l1 relative": _set(("eval", "mel_l1"), lambda t: 0.61 * _base(t)),
    "mel_l1 absolute": _set(("eval", "mel_l1"), 0.46),
    "spec_corr": _set(("eval", "spec_corr"), 0.84),
    "f0_corr": _set(("eval", "f0_corr"), 0.69),
    "periodicity": _set(("eval", "periodicity"), 0.54),
}
VOCODER_RICH = {
    "mel_l1 relative": _set(("eval", "mel_l1"), lambda t: 0.61 * _base(t)),
    "spec_corr": _set(("eval", "spec_corr"), 0.84),
    "f0_corr": _set(("eval", "f0_corr"), 0.89),
    "periodicity": _set(("eval", "periodicity"), 0.54),
}


def _jax_token(module, checks):
    return lambda t: _jax_verdict([getattr(module, c) for c in checks], t)


CASES = {  # name: (recorded file, port gate, JAX verdict, mutations)
    "token_chain_v1": ("token_chain.json", token_chain_proof.gate_failures,
                       _jax_token(V1, ["test_continuous_chain_matches_synthesis_fixture",
                                       "test_tokens_cost_bounded_degradation",
                                       "test_every_codeword_used"]), TOKEN_V1),
    "token_chain_rich": ("token_chain_rich.json", token_chain_proof.gate_failures,
                         _jax_token(RICH, ["test_continuous_chain_quality",
                                           "test_tokens_cost_bounded_degradation",
                                           "test_codebook_saturation_broken",
                                           "test_per_utt_pitch_modulation_gates"]), TOKEN_RICH),
    "production": ("token_chain_prod.json", production_codebooks.gate_failures,
                   _jax_token(PROD, ["test_fit_corpus_is_production_scale",
                                     "test_production_codebook_usage",
                                     "test_quantization_fidelity",
                                     "test_chain_quality_through_production_tokens"]), PROD_ROWS),
    "vocoder_v1": ("mini_vocoder.json", vocoder_proof.gate_failures,
                   lambda m: _jax_verdict([VOC.test_recorded_eval_beats_random_init],
                                          {"meta": m}), VOCODER_V1),
    "vocoder_rich": ("mini_vocoder_rich.json", vocoder_proof.gate_failures,
                     lambda m: _jax_verdict([RICH_FX.test_rich_vocoder_recorded_eval],
                                            {"meta": m}), VOCODER_RICH),
}
MUTATIONS = [(case, name) for case, (_, _, _, muts) in CASES.items() for name in muts]


@pytest.mark.parametrize("case", list(CASES))
def test_every_recorded_table_passes_both(case):
    fname, port_gate, jax_verdict, _ = CASES[case]
    table = _recorded(fname)
    assert port_gate(table) == [] and jax_verdict(table)


@pytest.mark.parametrize("case,mutation", MUTATIONS)
def test_a_table_past_a_gate_fails_both(case, mutation):
    fname, port_gate, jax_verdict, muts = CASES[case]
    table = copy.deepcopy(_recorded(fname))
    muts[mutation](table)
    assert port_gate(table) and not jax_verdict(table)


def _pitch_verdict(table, tmp_path, monkeypatch):
    path = tmp_path / "token_chain_rich_pitch.json"
    path.write_text(json.dumps(table))
    monkeypatch.setattr(PITCH, "CHAIN", path)
    return _jax_verdict([PITCH.test_pitch_chain_table], None)


def test_the_recorded_pitch_table_passes_both(tmp_path, monkeypatch):
    table = _recorded("token_chain_rich_pitch.json")
    assert pitch_chain_proof.gate_failures(table) == []
    assert _pitch_verdict(table, tmp_path, monkeypatch)


@pytest.mark.parametrize("mutation", list(PITCH_ROWS))
def test_a_pitch_table_past_a_gate_fails_both(mutation, tmp_path, monkeypatch):
    table = copy.deepcopy(_recorded("token_chain_rich_pitch.json"))
    PITCH_ROWS[mutation](table)
    assert pitch_chain_proof.gate_failures(table)
    assert not _pitch_verdict(table, tmp_path, monkeypatch)


@pytest.mark.parametrize("loud,pitch,supervised", [
    (None, None, True), (None, None, False), (0.59, None, True), (None, 0.49, True),
    (None, 0.49, False), (0.59, 0.49, False)])
def test_the_vq_eval_gate_gives_the_parity_test_verdict(loud, pitch, supervised):
    ev = dict(_recorded("mini_vq_synth.json")["eval"])
    if loud is not None:
        ev["loud_corr"] = loud
    if pitch is not None:
        ev["pitch_corr"] = pitch
    want = _jax_verdict([V1.test_vq_recorded_eval_passes_gates],
                        {"meta": {"eval": ev}, "supervised": supervised})
    assert (eval_gate_failures(ev, supervised) == []) == want
    assert want == (loud is None and (pitch is None or not supervised))
