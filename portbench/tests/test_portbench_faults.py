"""A run with the timed path broken underneath comes out not correct, and
the control (the reference with float8 operands in the program's place)
separates from the program, at sizes a CPU test holds: each cell's run
driven past the look for a chip, on the CPU, at a reduced width and depth,
with the cell's own limits. The faults are those a one-chip cell can have
(``harness/faults.py``): a step that returns its state unchanged, half the
batch left out (training), a token altered where it is produced (serving).

The control's readings grow with depth and width (48 layers at the
published widths on the card): there it fails the cell's limits (the
readings are in the limits files and PERF.md); here it reads at least
three times the program in one of the cell's compared numbers."""
import copy
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate
from portbench.harness import faults, manifest
from portbench.tests.candidates import with_candidates

ROOT = Path(__file__).resolve().parents[2]
M = manifest.Manifest(with_candidates(manifest.Manifest.load(ROOT).data), ROOT)
SEED = 2 ** 31 + 4242

# reduced widths: what the CPU holds in a test
TEST_MODEL = {
    "mamba2-1.3b": dict(n_layers=2, d_model=256, vocab_size=4096, ssm_state=32,
                        ssm_head_dim=32, ssm_chunk=16),
    "hubert-xlarge": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                          d_ff=512, vocab_size=504),
}
TEST_TRAFFIC = {"train": dict(seq_len=64, global_batch=4),
                "serve": dict(rate_per_s=40.0, slots=4, check_requests=12,
                              prompt=dict(median=32, sigma=0.6, grid=16, min=16, max=64),
                              output=dict(median=4, sigma=0.6, min=2, max=8))}
TEST_SECONDS = {"train": 0.0, "serve": 0.5}


def cell_at_test_size(workload: str):
    cell = M.cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TEST_MODEL[cell.config_name])
    cell.traffic = dict(cell.traffic, **TEST_TRAFFIC[cell.traffic["kind"]])
    return cell


def run(cell):
    driver = manifest.load_by_path("drivers", cell.traffic["kind"])
    return driver.run(cell, SEED, TEST_SECONDS[cell.traffic["kind"]], False,
                      torch.device("cpu"), time.perf_counter())


WORKLOADS = [w for w in M.workloads]
PLANTED = [(w, name) for w in WORKLOADS
           for name in (faults.TRAIN if M.cell(w).traffic["kind"] == "train" else faults.SERVE)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = run(cell_at_test_size(workload))
    assert out.notes["correct"], out.checks


@pytest.mark.parametrize("workload, fault", PLANTED)
def test_fault_is_not_correct(workload, fault):
    cell = cell_at_test_size(workload)
    table = faults.TRAIN if cell.traffic["kind"] == "train" else faults.SERVE
    with table[fault]():
        out = run(cell)
    assert not out.notes["correct"], out.checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_separates_from_the_program(workload):
    cell = cell_at_test_size(workload)
    by_kind = {"train": calibrate.train_seed, "serve": calibrate.serve_seed}
    kind = cell.traffic["kind"]
    line = by_kind[kind](cell, SEED, torch.device("cpu"), True, False, TEST_SECONDS[kind])
    assert any(line["control"][k] >= 3 * line["program"][k] > 0
               for k in cell.limits["compared"]), line
