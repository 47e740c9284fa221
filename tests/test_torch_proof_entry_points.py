"""The evaluation entry points end to end on the CPU at toy sizes: each
writes the recorded table's keys under its ``--out-dir`` and nothing under
``tests/fixtures`` or the working directory.

- ``token_chain_proof`` (a refit of 8 centres, 2 ODE steps) and
  ``--codebooks recorded`` (the checked-in codebook, the usage counted on
  the pooled features);
- ``pitch_chain_proof`` (its four rows);
- ``production_codebooks`` (8 and 16 centres on 6 continuum utterances);
- ``demo --mini-fixtures`` with ``--audio-out`` and ``--plot``: a finite
  waveform of the resynthesized frames x 320, written with the articulation
  and the plot into ``--out-dir``.

The JAX side of each module's pieces is in its own test file
(``test_torch_token_chain.py``, ``test_torch_pitch_chain.py``,
``test_torch_production_codebooks.py``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sylber_tpu_torch import demo, pitch_chain_proof, production_codebooks, token_chain_proof

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True)
def _untouched(tmp_path, monkeypatch):
    """Run in an empty working directory; fixtures and cwd stay as they were."""
    torch.set_num_threads(2)
    before = {p.name: p.stat().st_mtime_ns for p in FIXTURES.iterdir()}
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    yield
    assert {p.name: p.stat().st_mtime_ns for p in FIXTURES.iterdir()} == before
    assert not any(cwd.iterdir())


def _keys_cover(recorded, table, row_map):
    assert set(recorded) - {"table"} <= set(table)
    for want_row, got_row in row_map.items():
        assert set(recorded["table"][want_row]) <= set(table["table"][got_row]), got_row


def test_token_chain_refit_writes_its_table_and_codebooks(tmp_path):
    out = token_chain_proof.main(["--sizes", "8", "--n-utts", "4", "--n-eval", "2",
                                  "--seconds", "2", "--steps", "2", "--out-dir",
                                  str(tmp_path / "run"), "--skip-gates", "--device", "cpu"])
    table = json.loads((tmp_path / "run" / "token_chain.json").read_text())
    _keys_cover(json.loads((FIXTURES / "token_chain.json").read_text()), table,
                {"features": "features", "km64": "km8"})
    assert table["codebooks_from"] == "refit"
    assert table["codebooks"] == {"8": "mini_codebook_8.npy"}
    cb = np.load(tmp_path / "run" / "mini_codebook_8.npy")
    assert cb.shape == (8, 144) and cb.dtype == np.float16
    assert out["gates_missed"] == token_chain_proof.gate_failures(table)
    assert table["table"]["km8"]["codebook_usage"] <= 8


def test_token_chain_on_a_recorded_codebook(tmp_path):
    out = token_chain_proof.main(["--codebooks", "recorded", "--sizes", "64", "--n-utts", "2",
                                  "--n-eval", "2", "--seconds", "2", "--steps", "2",
                                  "--out-dir", str(tmp_path / "run"), "--skip-gates",
                                  "--device", "cpu"])
    row = out["table"]["km64"]
    assert row["kmeans_inertia"] is None and 0 < row["codebook_usage"] <= 64
    assert out["codebooks_from"] == "recorded"
    assert out["codebooks"] == {64: "mini_codebook_64.npy"}
    assert not list((tmp_path / "run").glob("*.npy"))


def test_pitch_chain_writes_its_rows(tmp_path):
    out = pitch_chain_proof.main(["--n-eval", "2", "--seconds", "2", "--steps", "2",
                                  "--out-dir", str(tmp_path / "run"), "--skip-gates",
                                  "--device", "cpu"])
    table = json.loads((tmp_path / "run" / "token_chain_rich_pitch.json").read_text())
    recorded = json.loads((FIXTURES / "token_chain_rich_pitch.json").read_text())
    _keys_cover(recorded, table, {row: row for row in recorded["table"]})
    assert set(table["table"]) == set(recorded["table"])
    assert out["gates_missed"] == pitch_chain_proof.gate_failures(table)


def test_production_codebooks_write_their_table(tmp_path):
    out = production_codebooks.main(["--n-utts", "6", "--sizes", "8", "16", "--n-eval", "2",
                                     "--seconds", "2", "--steps", "2", "--out-dir",
                                     str(tmp_path / "run"), "--skip-gates", "--device", "cpu"])
    table = json.loads((tmp_path / "run" / "token_chain_prod.json").read_text())
    recorded = json.loads((FIXTURES / "token_chain_prod.json").read_text())
    _keys_cover(recorded, table, {"features": "features", "km5000": "km16"})
    assert table["fit_corpus"]["n_utts"] == 6 and table["fit_corpus"]["n_segments"] > 16
    for K in (8, 16):
        row = table["table"][f"km{K}"]
        assert row["codebook_usage"] <= K and row["quant_snr_db"] > 0
        assert np.load(tmp_path / "run" / f"mini_codebook_prod_{K}.npy").shape == (K, 144)
    assert out["gates_missed"] == production_codebooks.gate_failures(table)


def test_demo_writes_into_its_out_dir(tmp_path):
    out = demo.main(["--wav", str(FIXTURES / "speechlike.wav"), "--mini-fixtures", "--steps",
                     "2", "--audio-out", "resynth.wav", "--plot", "--out-dir",
                     str(tmp_path / "demo"), "--device", "cpu"])
    w = out["waveform"]
    assert len(out["segments"]) > 0 and np.isfinite(w).all()
    assert len(w) == out["art"].shape[1] * 320
    np.testing.assert_array_equal(np.load(tmp_path / "demo" / "articulation.npy"), out["art"][0])
    sr, pcm = wavfile.read(tmp_path / "demo" / "resynth.wav")
    assert sr == 16000 and len(pcm) == len(w)
    assert sorted(p.name for p in (tmp_path / "demo").iterdir()) == [
        "articulation.npy", "resynth.wav", "similarity.png"]
