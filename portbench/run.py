"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process runs one cell of ``BENCHMARK.json``:
it builds (or loads) the port's kernels, makes the weights from the seed on
the card, warms up the cell's own shapes, measures for ``--seconds``, checks
what the timed path produced against the plain reference under
``portbench/reference/`` and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``. The compared numbers and their limits are the last lines on
standard error and the line's last key. The program's own output goes to
standard error.

Exit codes: 0 a result printed (``correct`` may be false); 2 the manifest,
a file it names or the port cannot be loaded; 3 no CUDA device, or fewer
than the cell asks for; 4 JAX or the JAX package was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level module names


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every kernel and build cache at a fixed path inside the checkout (the
    port's own nvcc build is ``build/repro_torch/``, fixed in its code)."""
    base = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def result_line(run, metrics: dict, trace: bool) -> dict:
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(run.notes.get("correct")), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness.manifest import Manifest, ManifestError, load_by_path
    try:
        manifest = Manifest.load(ROOT)
        cell = manifest.cell(args.workload)
        driver = load_by_path("drivers", cell.traffic["kind"], manifest.base)
        metrics = [(m, load_by_path("metrics", m.name, manifest.base))
                   for m in (cell.per_layer if args.trace else cell.end_to_end)]
    except ManifestError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port cannot be imported from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
        values = {}
        for m, reader in metrics:
            v = reader.read(run)
            if v is not None:
                values[m.name] = {"value": float(v), "unit": m.unit}
    found = forbidden_modules()
    if found:
        print(f"portbench: the run imported {found}", file=sys.stderr)
        return 4
    line = result_line(run, values, bool(args.trace))
    if run.trace is not None:   # where the profiler lost kernel events, said here
        run.notes["kernel_events_scaled_by_calls"] = run.trace.scaled()
    print(json.dumps({k: v for k, v in run.notes.items() if k != "correct"}, default=str),
          file=sys.stderr)
    for name, (v, lim) in run.checks.items():
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
