"""BENCHMARK.json and the files it names: found by name, parsed, and within
the format's limits (names, units, bounds, keys)."""

import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(c in CELLS for c in m.get("workloads", []))


def test_layers_named_as_perf_md_lists_them():
    """Each ``layer`` is written, letter for letter, in ``PERF.md``'s list of
    layers, so metrics of one layer give the same name."""
    text = (spec.CHECKOUT / "PERF.md").read_text()
    layers = text[text.index("## 3. Layers"):text.index("## 4.")]
    assert [m["layer"] for m in BENCH["per_layer"] if f"`{m['layer']}`" not in layers] == []


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    assert cell.workload["name"] == name and cell.config["name"] == cell.workload["config"]
    assert hasattr(spec.driver(cell.workload["driver"]), "run")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer and all(m["moves"] in reported for m in cell.per_layer)
    assert set(cell.workload["check"]["limits"]) and cell.workload["check"]["control"]
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200
    cfg = spec.config(name)
    assert cfg["reduced"] == entry["reduced"]
    assert not [k for k in entry["reduced"] if k.endswith(("_dim", "_rank", "_size"))]


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers(name):
    assert callable(spec.reader(name))


def test_each_reader_file_reads_a_metric():
    """A metric's reader is ``metrics/<stem>.py``, the stem its name before
    the first dot; every file there is some metric's reader."""
    files = {p.stem for p in (spec.ROOT / "metrics").glob("*.py")}
    assert files == {name.split(".")[0] for name in METRICS}
    assert spec.reader("mfu.segment") is not None and spec.reader("mfu") is not None


def test_a_name_is_no_path():
    with pytest.raises(ValueError):
        spec.workload("../BENCHMARK")
