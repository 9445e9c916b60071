"""A later change adds a cell, a configuration, a traffic mix or a per-layer
metric with new files and new entries alone. Shown on a temporary copy of
the manifest and of portbench's data folders; nothing in the checkout is
written."""
import json
import shutil
from pathlib import Path

from portbench.harness import manifest
from portbench.harness.record import Run

ROOT = Path(__file__).resolve().parents[2]
FOLDERS = ("configs", "traffic", "metrics", "limits", "drivers", "reference")


def _copy(tmp: Path) -> Path:
    for sub in FOLDERS:
        shutil.copytree(ROOT / "portbench" / sub, tmp / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def _snapshot():
    return {p: p.stat().st_mtime_ns for sub in FOLDERS
            for p in (ROOT / "portbench" / sub).rglob("*") if p.is_file()}


def test_new_cell_config_traffic_and_metric_are_files_and_entries(tmp_path):
    before = _snapshot()
    root = _copy(tmp_path)
    base = root / "portbench"
    old = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    data = json.loads((root / "BENCHMARK.json").read_text())

    conf = json.loads((base / "configs" / "mamba2-1.3b.json").read_text())
    conf["name"] = "mamba2-2.7b"
    conf["model"].update(arch_id="mamba2-2.7b", n_layers=64, d_model=2560)
    (base / "configs" / "mamba2-2.7b.json").write_text(json.dumps(conf))
    data["configs"].append({"name": "mamba2-2.7b",
                            "source": "https://huggingface.co/state-spaces/mamba2-2.7b",
                            "file": "portbench/configs/mamba2-2.7b.json", "reduced": [],
                            "why": "a wider SSD stack"})
    traffic = json.loads((base / "traffic" / "serve-azure-code.json").read_text())
    traffic.update(slots=128, prompt=dict(traffic["prompt"], median=1020),
                   output=dict(traffic["output"], median=129))
    (base / "traffic" / "serve-chat-b32.json").write_text(json.dumps(traffic))
    (base / "limits" / "mamba2-2.7b.serve-chat-b32.json").write_text(
        json.dumps({"compared": {"served_logit_gap": {"limit": 1.0}}}))
    data["workloads"].append({"name": "mamba2-2.7b.serve-chat-b32", "config": "mamba2-2.7b",
                              "traffic": "serve-chat-b32", "chips": 1,
                              "why": "chat: short prompts, long answers; decode does the work"})
    data["end_to_end"].append({"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["mamba2-2.7b.serve-chat-b32"]})
    (base / "metrics" / "ttft_p50_ms.serve.py").write_text(
        "from portbench.harness import stats\n\n\ndef read(run):\n"
        "    return stats.percentile(run.ttft_s, 50) * 1e3 if run.ttft_s else None\n")
    data["per_layer"].append({"name": "ttft_p50_ms.serve", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "entry", "moves": "ttft_p95_ms",
                              "workloads": ["mamba2-2.7b.serve-chat-b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    assert manifest.check(data) == []
    m = manifest.Manifest.load(root)
    cell = m.cell("mamba2-2.7b.serve-chat-b32")
    assert cell.model["n_layers"] == 64 and cell.traffic["slots"] == 128
    assert [x.name for x in cell.per_layer][-1] == "ttft_p50_ms.serve"
    reader = manifest.load_by_path("metrics", "ttft_p50_ms.serve", m.base)
    assert reader.read(Run(cell=cell, seed=0, ttft_s=[0.1, 0.3, 0.2])) == 200.0
    assert manifest.load_by_path("drivers", cell.traffic["kind"], m.base).run
    # the old cells are as they were, and no file that was there changed
    assert m.cell("mamba2-1.3b.train-bypass-4x2048").traffic["global_batch"] == 4
    for rel, raw in old.items():
        assert (base / rel).read_bytes() == raw
    assert _snapshot() == before
