"""Serving traffic: an open loop of requests at a fixed rate, served as a
continuous-batching server serves them over the program's steps
(``runtime/steps``' prefill and decode steps, each ended by a synchronise).

The traffic file gives the arrival rate, the prompt and output lengths
(log-normal, by median and sigma, clipped, prompts on a grid of tokens), the
decode slots and what the check and the trace take. A run offers
``round(rate * seconds)`` requests. Their prompt lengths, output lengths and
gaps between arrivals are the quantiles of those distributions at
(i + 1/2) / n (the gaps exponential: Poisson arrivals), each list in an
order drawn from the traffic file's ``schedule_seed``: every seed serves the
same schedule, since the tail of an open-loop queue swings with where the
long prompts fall. The run's seed makes the inputs: the weights and the
prompt ids, uniform over the vocabulary, drawn from the seed and the
request's index. Every output token is greedy.

The server is one host thread that polls while idle (no sleep: a woken host
issues its next steps slower). Whenever requests have arrived and a slot is
free, it prefills each alone (batch 1), takes its first token and copies its
recurrent state into the slot. Then one decode step advances every live
request, over the first slots up to the live count rounded up to a power of
two (so decode runs at few shapes). A request that has all its tokens
leaves, and the last live slot moves into its place. Time to first token
runs from the request's arrival to its first token; time per output token
from the first token to the last, over the tokens after the first. The
window opens at the first arrival's due time and closes when the last
request is done, or ``drain_s`` after the last arrival (what is left then
counts as failed). Set-up prefills every prompt length of the run once and
decodes once at every slot count the decode uses. A traced run serves the
window's first ``trace_requests`` requests again (fresh prompts, the same
arrivals) under the profiler, and ``attribution_requests`` more with the
host's ops recorded.

The slot cache is the program's ``init_cache`` at ``slots`` rows; a
family's cache leaves hold the batch at dim 1 (mamba2: the SSD and conv
states, whose rows are position-free).
"""
from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import checks, program
from portbench.harness.record import Run
from portbench.harness.trace import profiled, summarize
from portbench.reference import steps

WINDOW_STREAM, WARMUP_STREAM, TRACE_STREAM = 0, 1, 2


@dataclass
class Request:
    idx: int
    at: float            # arrival, seconds after the window opens
    prompt_len: int
    out_len: int
    tokens: List[int] = field(default_factory=list)
    t_first: float = 0.0


def _entropy(seed: int) -> int:
    return int(seed) % (1 << 64)


def _mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """The (i + 1/2) / n quantiles of a log-normal of ``median`` and
    ``sigma``, rounded to the ``grid`` and clipped to [min, max]."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf(q) for q in _mid_quantiles(n)])
    v = spec["median"] * np.exp(spec["sigma"] * z)
    grid = spec.get("grid", 1)
    v = np.round(v / grid) * grid
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def plan(traffic: dict, seconds: float) -> List[Request]:
    """The run's requests in order of arrival (the same for every seed)."""
    n = int(round(traffic["rate_per_s"] * seconds))
    prompts = lognormal_lengths(traffic["prompt"], n)
    outs = lognormal_lengths(traffic["output"], n)
    gaps = -np.log1p(-_mid_quantiles(n)) / traffic["rate_per_s"]
    order = [np.random.default_rng([traffic["schedule_seed"], 5, k]).permutation(n)
             for k in range(3)]
    at = np.cumsum(gaps[order[2]]) - gaps[order[2]][0] if n else gaps
    return [Request(idx=i, at=float(at[i]), prompt_len=int(prompts[order[0][i]]),
                    out_len=int(outs[order[1][i]])) for i in range(n)]


def prompt_tokens(seed: int, stream: int, index: int, length: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng([_entropy(seed), 4, stream, index])
    return rng.integers(0, vocab, size=(1, length), dtype=np.int64)


def bucket(n: int, slots: int) -> int:
    return min(slots, 1 << max(0, n - 1).bit_length())


class Server:
    """Prefill alone, decode the live slots together, over the program's steps."""

    def __init__(self, cfg, params, traffic: dict, device: torch.device):
        from repro_torch.models import lm
        from repro_torch.runtime.steps import make_decode_step, make_prefill_step
        self.params, self.device = params, device
        self.slots = traffic["slots"]
        max_len = traffic["prompt"]["max"] + traffic["output"]["max"]
        self.prefill = make_prefill_step(cfg, max_len)
        self.decode = make_decode_step(cfg)
        self.cache = lm.init_cache(cfg, self.slots, max_len, device)
        self.last = torch.zeros(self.slots, dtype=torch.int32, device=device)
        self.pos = torch.zeros(self.slots, dtype=torch.int32, device=device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, slot: int, tokens: np.ndarray) -> int:
        """Prefill one prompt into ``slot``; its first token (synchronised)."""
        logits, cache = self.prefill(self.params,
                                     {"tokens": torch.from_numpy(tokens).to(self.device)})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for k, v in cache.items():
            self.cache[k][:, slot].copy_(v[:, 0])
        self.last[slot] = tok[0]
        self.pos[slot] = tokens.shape[1]
        return int(tok[0].item())

    def _step(self, n: int) -> List[int]:
        """One decode step of the ``n`` live slots (synchronised)."""
        b = bucket(n, self.slots)
        view = {k: v[:, :b] for k, v in self.cache.items()}
        nxt, _, _ = self.decode(self.params, view, self.last[:b], self.pos[:b])
        self.last[:b].copy_(nxt)
        self.pos[:b] += 1
        return nxt[:n].tolist()

    def _move(self, src: int, dst: int) -> None:
        for v in self.cache.values():
            v[:, dst].copy_(v[:, src])
        self.last[dst] = self.last[src]
        self.pos[dst] = self.pos[src]

    def warm(self, lengths, seed: int, vocab: int) -> None:
        """Every prompt length once, and a decode step at every slot count."""
        for j, P in enumerate(sorted(set(lengths))):
            self._admit(0, prompt_tokens(seed, WARMUP_STREAM, j, P, vocab))
        n = 1
        while True:
            self._step(n)
            if n >= self.slots:
                break
            n = bucket(n + 1, self.slots)
        self.sync()

    def serve(self, reqs: List[Request], prompts, t0: float, drain_s: float,
              out: Run = None) -> Dict[int, List[int]]:
        """Serve ``reqs`` (arrivals after ``t0``); each finished request's
        served tokens by index. With ``out``, record the times there."""
        pending = collections.deque(reqs)
        live: List[Request] = []
        done: Dict[int, List[int]] = {}
        stop = t0 + (reqs[-1].at if reqs else 0.0) + drain_s
        while pending or live:
            now = time.perf_counter()
            if now > stop:
                break
            while pending and t0 + pending[0].at <= now and len(live) < self.slots:
                r = pending.popleft()
                t1 = time.perf_counter()
                first = self._admit(len(live), prompts(r))
                r.t_first = time.perf_counter()
                r.tokens = [first]
                if out is not None:
                    out.ttft_s.append(r.t_first - (t0 + r.at))
                    out.prefill_s.append(r.t_first - t1)
                    out.prefill_lens.append(r.prompt_len)
                if r.out_len <= 1:
                    done[r.idx] = r.tokens
                else:
                    live.append(r)
                now = time.perf_counter()
            if not live:   # poll for the next arrival: a host that sleeps wakes slow
                while pending and time.perf_counter() < t0 + pending[0].at:
                    pass
                continue
            t1 = time.perf_counter()
            toks = self._step(len(live))
            t2 = time.perf_counter()
            if out is not None:
                out.decode_s.append(t2 - t1)
            for r, tok in zip(live, toks):
                r.tokens.append(tok)
            for j in reversed(range(len(live))):
                r = live[j]
                if len(r.tokens) < r.out_len:
                    continue
                done[r.idx] = r.tokens
                if out is not None:
                    out.tpot_s.append((t2 - r.t_first) / (r.out_len - 1))
                if j != len(live) - 1:
                    self._move(len(live) - 1, j)
                    live[j] = live[-1]
                live.pop()
        return done


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Run:
    model, traffic = cell.model, cell.traffic
    cfg = program.config(model)
    fam = steps.family(cell.config["reference"])
    V = model["vocab_size"]
    reqs = plan(traffic, seconds)
    params = fam.make_params(model, seed, device, getattr(torch, model["param_dtype"]))
    server = Server(cfg, params, traffic, device)
    server.warm([r.prompt_len for r in reqs], seed, V)

    def window_prompt(r: Request) -> np.ndarray:
        return prompt_tokens(seed, WINDOW_STREAM, r.idx, r.prompt_len, V)

    out = Run(cell=cell, seed=seed, batch=1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    served = server.serve(reqs, window_prompt, t0, traffic["drain_s"], out)
    t_end = time.perf_counter()
    out.setup_s, out.window_s = t0 - t_start, t_end - t0
    out.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    out.attempted = len(reqs)
    out.requests = len(served)
    out.failed = sum(1 for r in reqs if r.idx not in served
                     or any(not 0 <= t < V for t in served[r.idx]))
    by_len: Dict[int, List[float]] = {}
    for s, P in zip(out.prefill_s, out.prefill_lens):
        by_len.setdefault(P, []).append(s)
    out.notes.update(
        offered=len(reqs), served=len(served), arrivals_s=reqs[-1].at if reqs else 0.0,
        drain_s=t_end - t0 - (reqs[-1].at if reqs else 0.0),
        served_tokens=sum(len(t) for t in served.values()),
        decode_steps=len(out.decode_s),
        prefill_ms_median=statistics.median(out.prefill_s) * 1e3 if out.prefill_s else None,
        prefill_ms_by_len={P: statistics.median(s) * 1e3 for P, s in sorted(by_len.items())
                           if P in (min(by_len), max(by_len))},
        decode_ms_quartiles=[float(x) * 1e3 for x in np.percentile(
            out.decode_s, [25, 50, 75, 100])] if out.decode_s else [])

    if trace:
        k, a = traffic["trace_requests"], traffic["attribution_requests"]
        timed, attribution = {}, {}
        stretches = ((timed, False, reqs[:k], 0), (attribution, True, reqs[k:k + a], k))
        for rec, host, part, first in stretches:
            again = [Request(idx=first + i, at=r.at - part[0].at, prompt_len=r.prompt_len,
                             out_len=r.out_len) for i, r in enumerate(part)]
            with profiled(rec, server.sync, host):
                server.serve(again, lambda r: prompt_tokens(seed, TRACE_STREAM, r.idx,
                                                            r.prompt_len, V),
                             time.perf_counter(), traffic["drain_s"])
        out.trace = summarize(timed["prof"], attribution["prof"], timed["window_s"], k)
        del timed, attribution

    del server, params
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    finished = [r for r in reqs if r.idx in served]
    out.answers = ([(r.idx, r.prompt_len) for r in finished],
                   lambda idx, P: prompt_tokens(seed, WINDOW_STREAM, idx, P, V)[0],
                   served)
    checks.serve(out, fam, model, traffic, seed, device)
    return out
