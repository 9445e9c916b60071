"""Training traffic: the program's ``TrainerRuntime`` fed by its dataplane.

Set-up builds one trainer, the weights from the seed and the AdamW state,
and drives that trainer through the first ``check_steps`` steps of the
stream (its own ``run`` call and feed, each step a fresh batch). Those steps
are what the reference follows: each step's loss, each leaf's first clipped
gradient (worked out from the first moment after step 1) and each leaf's
change over the steps (from the f32 master copy). The same trainer and
state then run the window: ``TrainerRuntime.run`` takes a step count, so the
window's count is sized from the set-up steps' time to fill ``--seconds``,
and the window lasts as long as those steps take. A traced run profiles
``trace_steps`` more steps after the window.
"""
from __future__ import annotations

import statistics
import time

import torch

from portbench.harness import checks, program
from portbench.harness.record import Run
from portbench.harness.trace import profiled, summarize
from portbench.reference import common, steps

LOG_EVERY = 1  # the trainer logs every step's loss: the window's failed steps are read from them


def _norms(tree, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in common.leaves(tree)}


def set_up(cell, seed: int, device: torch.device):
    """The trainer, its state after the set-up steps, and the readings the
    reference follows: (trainer, state, {losses, first_grad, change,
    first_grad_host}): each step's loss, each leaf's first clipped gradient
    (its norm, and the tensor in bf16 on the host) and its change."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime, TrainerState

    model, traffic = cell.model, cell.traffic
    opt_cfg = adamw.AdamWConfig(**traffic["optimizer"])
    B, S, n_check = traffic["global_batch"], traffic["seq_len"], traffic["check_steps"]
    rt = TrainerRuntime(program.config(model), DataConfig(seq_len=S, global_batch=B, seed=seed),
                        TrainerConfig(steps=1, ckpt_dir=None, feed=traffic["feed"],
                                      feed_ports=traffic["feed_ports"],
                                      feed_depth=traffic["feed_depth"], log_every=LOG_EVERY,
                                      seed=seed),
                        opt_cfg, device=device)
    fam = steps.family(cell.config["reference"])
    params = fam.make_params(model, seed, device, getattr(torch, model["param_dtype"]))
    start = {k: v.clone() for k, v in common.leaves(params)}
    state = TrainerState(params=params, opt_state=adamw.init(opt_cfg, params))
    del params

    state = rt.run(state)                               # step 1
    unbias = 1.0 / (1.0 - opt_cfg.beta1)                # m after one step: (1 - b1) g
    first_grad = _norms(state.opt_state.m, unbias)
    first_host = {k: (v * unbias).to("cpu", torch.bfloat16)
                  for k, v in common.leaves(state.opt_state.m)}
    rt.tcfg.steps = n_check
    state = rt.run(state)                               # steps 2 .. check_steps
    master = state.opt_state.master if opt_cfg.master_fp32 else state.params
    change = {k: float(torch.linalg.vector_norm(v.float() - start[k].float()))
              for k, v in common.leaves(master)}
    losses = [m["loss"] for m in rt.metrics_log[:n_check]]
    return rt, state, {"losses": losses, "first_grad": first_grad, "change": change,
                       "first_grad_host": first_host}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Run:
    traffic = cell.traffic
    B, S, n_check = traffic["global_batch"], traffic["seq_len"], traffic["check_steps"]
    rt, state, readings = set_up(cell, seed, device)
    # the set-up steps' device time (CUDA events) sizes the window: their host
    # time holds each run call's feed start, which a long run pays once
    sized = rt.device_times_s[1:n_check] or rt.step_times_s[1:n_check] or rt.step_times_s
    step_s = statistics.median(sized)
    n_steps = max(1, round(seconds / step_s))
    mark, logged = len(rt.step_times_s), len(rt.metrics_log)
    rt.tcfg.steps = state.step + n_steps
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = rt.run(state)
    _sync(device)
    t1 = time.perf_counter()
    out = Run(cell=cell, seed=seed, setup_s=t0 - t_start, window_s=t1 - t0,
              peak_bytes=_peak(device), steps=n_steps, tokens=n_steps * B * S,
              step_s=rt.step_times_s[mark:], issue_s=rt.issue_times_s[mark:],
              feed_s=rt.feed_times_s[mark:], attempted=n_steps)
    window_losses = [m["loss"] for m in rt.metrics_log[logged:]]
    out.failed = sum(1 for x in window_losses if x != x or abs(x) == float("inf"))
    out.notes.update(window_steps=n_steps, sized_from_step_s=step_s,
                     setup_step_s=rt.step_times_s[:n_check])

    if trace:
        timed, attribution = {}, {}
        for rec, host, n in ((timed, False, traffic["trace_steps"]), (attribution, True, 1)):
            rt.tcfg.steps = state.step + n
            with profiled(rec, lambda: _sync(device), host):
                state = rt.run(state)
        out.trace = summarize(timed["prof"], attribution["prof"], timed["window_s"],
                              traffic["trace_steps"])
        del timed, attribution

    del state, rt
    _free(device)
    checks.train(out, steps.family(cell.config["reference"]), cell.model, traffic, seed,
                 device, readings)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _free(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
