"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name."""
import copy
import dataclasses
import json
from pathlib import Path

import pytest

from portbench.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
M = manifest.Manifest(DATA, ROOT)


def test_manifest_keeps_the_rules():
    assert manifest.check(DATA) == []


def test_command_and_paths():
    assert DATA["command"] == ["python3", "portbench/run.py"]
    assert DATA["paths"] == ["portbench"]
    for word in DATA["command"]:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= DATA["run_seconds"] <= 51 and total <= 43200


def test_cells_take_one_chip_each_in_order():
    assert [(w["name"], w["chips"]) for w in DATA["workloads"]] == [
        ("mamba2-1.3b.train-bypass-4x2048", 1), ("hubert-xlarge.train-bypass-4x2048", 1)]


def test_candidate_cells_keep_the_rules_once_added():
    from portbench.tests.candidates import entries, with_candidates
    data = with_candidates(DATA)
    assert entries() and manifest.check(data) == []
    m = manifest.Manifest(data, ROOT)
    for c in entries():
        cell = m.cell(c["workload"]["name"])
        assert cell.limits["compared"] and cell.per_layer
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(manifest.load_by_path("metrics", metric.name).read)


@pytest.mark.parametrize("workload", [w["name"] for w in DATA["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = M.cell(workload)
    assert cell.config["name"] == cell.config_name
    assert manifest.load_by_path("drivers", cell.traffic["kind"]).run
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.load_by_path("metrics", m.name).read)
    assert "setup_s" in {m.name for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits["compared"]
    from portbench.reference import steps
    assert steps.family(cell.config["reference"]).make_params


@pytest.mark.parametrize("workload", [w["name"] for w in DATA["workloads"]])
def test_per_layer_moves_a_metric_its_cells_report(workload):
    e2e = {m.name for m in M.e2e_of(workload)}
    for m in M.per_layer_of(workload):
        assert m.moves in e2e


def test_layers_are_named_alike():
    layers = {m["layer"] for m in DATA["per_layer"]}
    assert layers == {"entry", "dataplane", "model step", "kernels", "device"}


# where the file takes the published config.json's number and the port's
# registry another (the registry's vocab is padded to 8, its eps its default)
PUBLISHED = {"mamba2-1.3b": {"vocab_size": 50288, "norm_eps": 1e-5},
             "hubert-xlarge": {"norm_eps": 1e-5}}


@pytest.mark.parametrize("entry", [c for c in DATA["configs"]], ids=lambda c: c["name"])
def test_config_files(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/")
    assert conf["reduced"] == entry["reduced"] == []
    assert conf["source"] == entry["source"]
    from repro_torch.models.registry import get_config
    from portbench.harness import program
    want = dataclasses.replace(get_config(entry["name"]), **PUBLISHED[entry["name"]])
    assert program.config(conf["model"]) == want


@pytest.mark.parametrize("bad, fault", [
    ({"name": "has space"}, "name rule"), ({"name": "a/b"}, "name rule"),
    ({"unit": "tokens per second"}, "unit"), ({"unit": "µs"}, "unit"),
    ({"better": "up"}, "better"), ({"source": "program_span"}, "source"),
    ({"bound": 0.3}, "bound"), ({"bound": 0.005}, "bound"), ({"why": "x"}, "keys")])
def test_check_finds_bad_end_to_end_entries(bad, fault):
    data = copy.deepcopy(DATA)
    data["end_to_end"][0].update(bad)
    assert any(fault in f for f in manifest.check(data))


def test_check_finds_bad_cells():
    data = copy.deepcopy(DATA)
    data["workloads"].append(dict(data["workloads"][0], name="twin"))
    assert any("twice" in f for f in manifest.check(data))
    data = copy.deepcopy(DATA)
    data["workloads"][0]["chips"] = 2
    assert any("chips" in f for f in manifest.check(data))
    data = copy.deepcopy(DATA)
    data["per_layer"][0]["moves"] = "nothing"
    assert any("moves" in f for f in manifest.check(data))


def test_a_missing_file_is_a_manifest_error(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(DATA))
    with pytest.raises(manifest.ManifestError):
        manifest.Manifest.load(tmp_path).cell(DATA["workloads"][0]["name"])
