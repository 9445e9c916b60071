"""Whether what the timed path produced is correct: its numbers against the
plain reference's, each held to the limit of the cell's limits file
(``limits/<workload>.json``: ``compared`` maps each number to its
``limit`` and the readings it was set from).

Training: the loss of each set-up step, each leaf's first clipped gradient
and each leaf's change over those steps, against the reference's run from
the same weights and batches. A gap of per-leaf norms is taken at the worst
leaf, over the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose first reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.

Serving: a sample of the window's requests drawn from the seed, the longest
prompt in it; the reference runs once over each prompt with its served
tokens, and the number is the widest gap by which a served token's logit
lies below the reference's best at its position.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import common, steps, synth

QUIET_LEAF = 1e-3  # of the median leaf's first gradient: left out of the change


def judge(out, numbers: Dict[str, float]) -> bool:
    """Hold each compared number to its limit; the others are kept as notes."""
    compared = out.cell.limits["compared"]
    ok = True
    for name, value in numbers.items():
        if name in compared:
            limit = compared[name]["limit"]
            out.checks[name] = (value, limit)
            ok = ok and value == value and value <= limit
        else:
            out.notes[name] = value
    missing = set(compared) - set(numbers)
    if missing:
        raise RuntimeError(f"no reading of the compared numbers {sorted(missing)}")
    out.notes["correct"] = ok
    return ok


# -- training -----------------------------------------------------------------

def reference_train(fam, model: dict, traffic: dict, seed: int, device,
                    prec: common.Precision, **kw) -> dict:
    """The reference's set-up steps from the seed's weights and batches
    (``kw``: ``steps.train``'s ``against`` and ``keep_first``)."""
    common.strict_f32()
    init = fam.make_params(model, seed, device, getattr(torch, model["param_dtype"]))
    batches = [synth.batch(model, traffic["seq_len"], traffic["global_batch"], seed, step)
               for step in range(traffic["check_steps"])]
    return steps.train(fam, model, init, batches, traffic["optimizer"], prec, device, **kw)


def train_numbers(prog: dict, ref: dict, name: str = "program") -> Dict[str, float]:
    """The gaps between the program's set-up steps and the reference's:
    ``loss_gap`` the worst step's relative loss gap, ``first_loss_gap`` the
    first step's; ``grad_gap`` and ``change_gap`` the worst leaf's gap of
    norms; ``grad_diff`` the worst leaf's norm of the difference of the first
    clipped gradients (``ref["first_grad_diff"][name]``), over the larger of
    the reference's norm of that leaf and of the median leaf."""
    losses = list(zip(prog["losses"], ref["losses"]))
    gaps = [abs(a - b) / abs(b) for a, b in losses]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [float("inf")]
    grad_gap, grad_leaf = steps.leaf_gap(prog["first_grad"], ref["first_grad"])
    med = statistics.median(ref["first_grad"].values())
    quiet = {k for k, g in ref["first_grad"].items() if g < QUIET_LEAF * med}
    change_gap, change_leaf = steps.leaf_gap(prog["change"], ref["change"], quiet)
    diff = ref["first_grad_diff"].get(name)
    grad_diff = (max(d / max(ref["first_grad"][k], med) for k, d in diff.items())
                 if diff else float("nan"))
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0], "grad_gap": grad_gap,
            "grad_diff": grad_diff, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf, "quiet_leaves": sorted(quiet)}


def train(out, fam, model: dict, traffic: dict, seed: int, device, prog: dict) -> bool:
    """``prog``: the program's losses, first gradients (norms, and the
    tensors on the host) and changes."""
    t0 = time.perf_counter()
    ref = reference_train(fam, model, traffic, seed, device, common.Precision("f32"),
                          against={"program": prog["first_grad_host"]})
    numbers = train_numbers(prog, ref)
    out.notes.update(reference_s=time.perf_counter() - t0, losses=prog["losses"],
                     reference_losses=ref["losses"])
    for key in ("grad_leaf", "change_leaf", "quiet_leaves"):
        out.notes[key] = numbers.pop(key)
    return judge(out, numbers)


# -- serving ------------------------------------------------------------------

def sample_requests(seed: int, finished: List[tuple], served: dict, n: int) -> List[tuple]:
    """``n`` of the finished requests ((index, prompt length)) drawn from the
    seed: one of the longest prompts and one of the longest outputs first."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    firsts: List[int] = []
    for size in (lambda i: finished[i][1], lambda i: len(served[finished[i][0]])):
        top = max(size(i) for i in range(len(finished)))
        pick = int(rng.choice([i for i in range(len(finished)) if size(i) == top]))
        if pick not in firsts:
            firsts.append(pick)
    rest = [i for i in range(len(finished)) if i not in firsts]
    picked = rng.choice(len(rest), size=max(0, min(n - len(firsts), len(rest))), replace=False)
    return [finished[i] for i in firsts] + [finished[rest[j]] for j in sorted(picked)]


def serve_gaps(fam, model: dict, params: dict, picks, prompt_of, served, device,
               prec: common.Precision, pick_by=None) -> List[float]:
    """Each sampled request's served tokens' gaps below the reference's best
    over its prompt and its served tokens (``pick_by``: judge instead the
    tokens that this other precision puts first, at the same positions of
    the same sequences)."""
    gaps: List[float] = []
    for idx, P in picks:
        toks = torch.as_tensor(served[idx], device=device).long()[None]    # (1, k)
        prompt = torch.as_tensor(prompt_of(idx, P), device=device).long()[None]
        k = toks.shape[1]
        seq = torch.cat([prompt, toks[:, :-1]], 1)
        at = torch.arange(P - 1, P - 1 + k, device=device)[None]
        ref = steps.logits_at(fam, model, params, seq, at, prec)
        if pick_by is not None:
            toks = steps.logits_at(fam, model, params, seq, at, pick_by).argmax(-1)
        gaps.extend(steps.served_gaps(ref, toks).flatten().tolist())
        del ref
    return gaps


def serve(out, fam, model: dict, traffic: dict, seed: int, device) -> bool:
    """``out.answers``: the finished requests (index, prompt length), their
    prompts by (index, length), and their served tokens by index."""
    finished, prompt_of, served = out.answers
    t0 = time.perf_counter()
    common.strict_f32()
    params = fam.make_params(model, seed, device, getattr(torch, model["param_dtype"]))
    picks = sample_requests(seed, finished, served, traffic["check_requests"])
    gaps = serve_gaps(fam, model, params, picks, prompt_of, served, device,
                      common.Precision("f32"))
    out.notes.update(reference_s=time.perf_counter() - t0, checked_requests=len(picks),
                     checked_tokens=len(gaps))
    return judge(out, {"served_logit_gap": max(gaps)})
