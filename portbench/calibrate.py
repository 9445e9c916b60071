"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--control 3] [--faults 3] [--seconds 10] [--out FILE]

In one process, on the card: for every seed, the numbers
that a run compares, of the program against the plain reference (their
largest over the seeds is the lower reading); for the first ``--control``
seeds the same numbers of the control, the reference computed with float8
operands in the program's place (its smallest is an upper reading); for
the first ``--faults`` seeds those of each fault of ``harness/faults.py``
planted in the program. Every reading is also judged against the cell's
limits as a run judges it (``correct`` and the numbers ``over`` their
limits), so the control and each fault show ``correct`` false. Each seed's
readings are one JSON line on standard output (and in ``--out``); the last
line sums them up.

Training runs the program's set-up steps only (no window); serving runs a
``--seconds`` window at the cell's own rate after the warm-up, and compares
as many requests as a run does.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def verdict(cell, seed: int, numbers: dict) -> dict:
    """``numbers`` held to the cell's limits as a run holds them."""
    from portbench.harness import checks
    from portbench.harness.record import Run
    run = Run(cell=cell, seed=seed)
    compared = {k: v for k, v in numbers.items() if k in cell.limits["compared"]}
    ok = checks.judge(run, compared)
    return dict(numbers, correct=ok,
                over=sorted(k for k, (v, lim) in run.checks.items() if not v <= lim))


def train_seed(cell, seed: int, device, control: bool, faults: bool,
               seconds: float = 0.0) -> dict:
    import torch
    from portbench.drivers import train
    from portbench.harness import checks, faults as planted
    from portbench.reference import common, steps

    def program():
        rt, state, readings = train.set_up(cell, seed, device)
        del rt, state
        _free(torch, device)
        return readings

    fam = steps.family(cell.config["reference"])
    runs = {"program": program()}
    if faults:
        for name, plant in planted.TRAIN.items():
            with plant():
                runs[f"fault:{name}"] = program()
    if control:
        runs["control"] = checks.reference_train(fam, cell.model, cell.traffic, seed, device,
                                                 common.Precision("fp8"), keep_first=True)
        _free(torch, device)
    ref = checks.reference_train(fam, cell.model, cell.traffic, seed, device,
                                 common.Precision("f32"),
                                 against={k: r["first_grad_host"] for k, r in runs.items()})
    out = {"seed": seed, "losses": runs["program"]["losses"], "reference_losses": ref["losses"]}
    for name, r in runs.items():
        out[name] = verdict(cell, seed, checks.train_numbers(r, ref, name))
    return out


def serve_seed(cell, seed: int, device, control: bool, faults: bool,
               seconds: float = 10.0) -> dict:
    import torch
    from portbench.drivers import serve
    from portbench.harness import checks, faults as planted
    from portbench.reference import common, steps

    def program():
        run = serve.run(cell, seed, seconds, False, device, time.perf_counter())
        _free(torch, device)
        return run

    run = program()
    out = {"seed": seed, "program": verdict(cell, seed, {
               "served_logit_gap": run.checks["served_logit_gap"][0]}),
           "requests": run.requests, "checked_tokens": run.notes["checked_tokens"]}
    if control:
        fam = steps.family(cell.config["reference"])
        finished, prompt_of, served = run.answers
        params = fam.make_params(cell.model, seed, device, torch.bfloat16)
        picks = checks.sample_requests(seed, finished, served, cell.traffic["check_requests"])
        gaps = checks.serve_gaps(fam, cell.model, params, picks, prompt_of, served, device,
                                 common.Precision("f32"), pick_by=common.Precision("fp8"))
        out["control"] = verdict(cell, seed, {"served_logit_gap": max(gaps)})
        del params
        _free(torch, device)
    if faults:
        for name, plant in planted.SERVE.items():
            with plant():
                out[f"fault:{name}"] = verdict(cell, seed, {
                    "served_logit_gap": program().checks["served_logit_gap"][0]})
    return out


def summary(lines: list) -> dict:
    """Per number: the largest of the program's readings (the lower
    reading), the smallest of the control's and of each fault's; per
    program, control and fault, how many of its runs were correct."""
    out: dict = {"correct_runs": {}}
    for line in lines:
        for who, nums in line.items():
            if not isinstance(nums, dict):
                continue
            tally = out["correct_runs"].setdefault(who, [0, 0])
            tally[0] += bool(nums.get("correct"))
            tally[1] += 1
            for name, v in nums.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                rec = out.setdefault(name, {})
                pick = max if who == "program" else min
                rec[who] = v if who not in rec else pick(rec[who], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness.manifest import Manifest
    cell = Manifest.load(ROOT).cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    by_kind = {"train": train_seed, "serve": serve_seed}[cell.traffic["kind"]]
    sink = open(args.out, "w") if args.out else None
    lines = []
    with contextlib.redirect_stdout(sys.stderr):
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            line = by_kind(cell, seed, device, i < args.control, i < args.faults,
                           args.seconds)
            line["seconds"] = time.perf_counter() - t0
            lines.append(line)
            text = json.dumps(line, default=str)
            print(text, file=sys.__stdout__, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
    text = json.dumps({"summary": summary(lines)})
    print(text)
    if sink:
        sink.write(text + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
