"""The rate a serving cell's system sustains, found once by a sweep on the
card (the cell itself offers load at the fixed rate of its traffic file).

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds 20 \
        --rates 4,6,8,10,12

One process: the cell's weights and warm-up once, then for each rate an
open-loop window of the cell's traffic at that rate. One JSON line a rate:
requests offered and served, the window, the drain after the last arrival,
time to first token and time per output token (median and 95th
percentile, and the 95th of the last third of arrivals against the
first's: a queue that grows all through the window shows there).
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from portbench.drivers import serve
    from portbench.harness import program
    from portbench.harness.manifest import Manifest
    from portbench.harness.record import Run
    from portbench.reference import steps
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = Manifest.load(ROOT).cell(args.workload)
    model, device = cell.model, torch.device("cuda", 0)
    V = model["vocab_size"]
    rates = [float(r) for r in args.rates.split(",")]
    plans = {r: serve.plan(dict(cell.traffic, rate_per_s=r), args.seconds)
             for r in rates}
    fam = steps.family(cell.config["reference"])
    with contextlib.redirect_stdout(sys.stderr):
        params = fam.make_params(model, args.seed, device, getattr(torch, model["param_dtype"]))
        server = serve.Server(program.config(model), params, cell.traffic, device)
        server.warm([q.prompt_len for p in plans.values() for q in p], args.seed, V)
    for r in rates:
        reqs, out = plans[r], Run(cell=cell, seed=args.seed)
        t0 = time.perf_counter()
        done = server.serve(reqs, lambda q: serve.prompt_tokens(
            args.seed, serve.WINDOW_STREAM, q.idx, q.prompt_len, V), t0,
            cell.traffic["drain_s"], out)
        window = time.perf_counter() - t0
        third = max(1, len(out.ttft_s) // 3)

        def ms(v, q):
            return float(np.percentile(v, q) * 1e3) if len(v) else None
        print(json.dumps({
            "rate": r, "offered": len(reqs), "served": len(done), "window_s": window,
            "drain_s": window - reqs[-1].at, "served_per_s": len(done) / window,
            "ttft_p50_ms": ms(out.ttft_s, 50), "ttft_p95_ms": ms(out.ttft_s, 95),
            "ttft_p95_first_third_ms": ms(out.ttft_s[:third], 95),
            "ttft_p95_last_third_ms": ms(out.ttft_s[-third:], 95),
            "tpot_p50_ms": ms(out.tpot_s, 50), "tpot_p95_ms": ms(out.tpot_s, 95),
            "prefill_ms_p50": ms(out.prefill_s, 50), "decode_ms_p50": ms(out.decode_s, 50),
            "decode_steps": len(out.decode_s)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
