"""Trainer runtime: the bypass-fed step loop with checkpoint/restart and
straggler handling (port of ``src/repro/runtime/trainer.py:60``), on one
device or on a mesh.

* **feed choice** — ``feed="bypass"`` (polling, multi-port, copies issued
  ahead on a side stream) or ``feed="kernel"`` (blocking baseline); one
  flag, same loop.
* **checkpoint/restart** — async checkpoints every ``ckpt_every`` steps; on
  start the trainer resumes from the latest valid checkpoint and
  fast-forwards the deterministic data stream to its step (exact replay).
* **straggler handling** — the bypass feed's poll deadline bounds how long a
  slow producer port can stall a step; on a timeout the runtime drops the
  in-flight transfers, refills from the staging rings, retries once, and
  counts the event in ``straggler_events``.

* **mesh** — given a DeviceMesh and axis rules, the params and optimizer
  state are DTensors laid out by ``parallel.specs`` (the MoE experts blocked
  for the mesh's model size), the steps run under the rules, each rank
  trains on its rows of the global batch the deterministic pipeline draws
  (so the data equal the unsharded run's), and a restore re-shards the
  checkpoint onto the mesh it finds (``src/repro/runtime/trainer.py:64-131``).
  Only rank 0 prints.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.dataplane import BypassDataplane, make_feed
from repro_torch.data.pipeline import DataConfig, stream_factory
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import axes
from repro_torch.parallel.specs import (batch_rows, batch_rules, expert_blocks,
                                        make_param_specs, make_shardings, place_tree)
from repro_torch.runtime.steps import make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    feed: str = "bypass"             # bypass | kernel
    feed_ports: int = 1
    feed_depth: int = 3
    step_deadline_s: float = 120.0   # straggler watchdog
    log_every: int = 10
    seed: int = 0


@dataclass
class TrainerState:
    params: Any
    opt_state: adamw.OptState
    step: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_events(device: torch.device):
    """(start, end) CUDA events around a step, the start recorded now; ()
    off CUDA."""
    if device.type != "cuda":
        return ()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    return start, end


class TrainerRuntime:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                 device: torch.device, mesh=None, rules: Optional[axes.AxisRules] = None):
        self.cfg = cfg
        self.dcfg = dcfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.device = torch.device(device)
        self.mesh = mesh
        self.rules = rules
        self.ckpt = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.metrics_log: List[dict] = []
        self.step_times_s: List[float] = []  # host time of each step, synchronised
        self.feed_times_s: List[float] = []  # host time of each step's next_batch
        # host time to issue each step's work (its train_step call, unsynchronised)
        self.issue_times_s: List[float] = []
        # device time of each train_step call between two CUDA events (CUDA only)
        self.device_times_s: List[float] = []
        self.straggler_events = 0
        self.feed = None

    # -- setup ------------------------------------------------------------------
    def _on_mesh(self) -> bool:
        return self.mesh is not None and self.rules is not None

    def _ctx(self):
        if self.rules is not None:
            return axes.axis_rules(batch_rules(self.rules, self.mesh, self.dcfg.global_batch),
                                   self.mesh)
        return contextlib.nullcontext()

    def _log(self, msg: str) -> None:
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(msg)

    def _shardings(self, params):
        """(param shardings, optimizer-state shardings) of the mesh's
        layout of ``params`` (whole or already placed), or (None, None)
        without a mesh; the step count stays a plain tensor."""
        if not self._on_mesh():
            return None, None
        pshard = make_shardings(make_param_specs(expert_blocks(params, self.mesh), self.rules,
                                                 self.mesh), self.mesh)
        oshard = adamw.OptState(step=None, master=pshard if self.opt_cfg.master_fp32 else (),
                                m=pshard, v=pshard)
        return pshard, oshard

    def place(self, params):
        """Whole params (the same on every rank) laid out on the mesh: the
        experts blocked for its model size, each leaf a DTensor holding this
        rank's chunk. As they are without a mesh."""
        pshard, _ = self._shardings(params)
        if pshard is None:
            return params
        return place_tree(expert_blocks(params, self.mesh), pshard)

    def init_state(self) -> TrainerState:
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.place(lm.init_params(self.cfg, gen, self.device))
        return TrainerState(params=params, opt_state=adamw.init(self.opt_cfg, params))

    def maybe_restore(self, state: TrainerState) -> TrainerState:
        if self.ckpt is None:
            return state
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        pshard, oshard = self._shardings(state.params)
        tree = {"params": state.params, "opt": state.opt_state}
        shardings = {"params": pshard, "opt": oshard} if pshard is not None else None
        restored, step, _ = self.ckpt.restore(latest, tree, shardings)
        self._log(f"[trainer] restored checkpoint @ step {step}")
        return TrainerState(params=restored["params"], opt_state=restored["opt"], step=step)

    # -- run -------------------------------------------------------------------
    def run(self, state: Optional[TrainerState] = None) -> TrainerState:
        """Train from ``state`` (or a fresh, possibly restored, one) up to
        ``tcfg.steps``. The given state's tensors are updated in place; on a
        mesh, a given state is laid out as ``place`` lays it out."""
        with self._ctx():
            return self._run(state)

    def _run(self, state: Optional[TrainerState]) -> TrainerState:
        tcfg = self.tcfg
        if state is None:
            state = self.maybe_restore(self.init_state())
        n_rows, own_rows = axes.batch_shards(), axes.batch_index()
        step_fn = make_train_step(self.cfg, self.opt_cfg)
        factory = stream_factory(self.cfg, self.dcfg, start_step=state.step,
                                 n_steps=tcfg.steps - state.step)
        feed = make_feed(tcfg.feed, factory, device=self.device, depth=tcfg.feed_depth,
                         ports=tcfg.feed_ports)
        self.feed = feed
        bypass = isinstance(feed, BypassDataplane)
        t_start = time.perf_counter()
        try:
            while state.step < tcfg.steps:
                t0 = time.perf_counter()
                try:
                    batch = (feed.next_batch(timeout_s=tcfg.step_deadline_s) if bypass
                             else feed.next_batch())
                except TimeoutError:
                    # straggler port: drop in-flight, refill, retry once
                    self.straggler_events += 1
                    feed.drop_inflight()
                    batch = feed.next_batch(timeout_s=tcfg.step_deadline_s)
                if batch is None:
                    break
                if n_rows > 1:
                    batch = batch_rows(batch, n_rows, own_rows)
                t_issue = time.perf_counter()
                self.feed_times_s.append(t_issue - t0)
                events = _step_events(self.device)
                params, opt_state, metrics = step_fn(state.params, state.opt_state, batch)
                state = TrainerState(params=params, opt_state=opt_state, step=state.step + 1)
                if events:
                    events[1].record()
                self.issue_times_s.append(time.perf_counter() - t_issue)
                _sync(self.device)
                self.step_times_s.append(time.perf_counter() - t0)
                if events:
                    self.device_times_s.append(events[0].elapsed_time(events[1]) / 1e3)
                if state.step % tcfg.log_every == 0 or state.step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = state.step
                    m["wall_s"] = round(time.perf_counter() - t_start, 2)
                    self.metrics_log.append(m)
                    self._log(f"[trainer] step {state.step}: loss={m['loss']:.4f} "
                              f"gnorm={m['grad_norm']:.3f} ({m['wall_s']}s)")
                if self.ckpt is not None and state.step % tcfg.ckpt_every == 0:
                    self.ckpt.save(state.step, {"params": state.params,
                                                "opt": state.opt_state},
                                   extra={"step": state.step})
        finally:
            feed.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        return state
