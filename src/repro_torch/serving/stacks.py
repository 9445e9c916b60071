"""Serving node stacks: balancer, prefill, decode — registered stack kinds.

All three are :class:`~repro_torch.core.netstack.NetworkStack` subclasses built by
the same registry (:func:`~repro_torch.exp.testbed.register_stack`) single-host
testbeds use, so they inherit the whole NIC/descriptor/lcore machinery: RSS
steering into multi-queue rings, writeback thresholds, per-queue
:class:`~repro_torch.core.netstack.ServerStats`, and virtual-time lcore busy
windows.

Execution model (prefill/decode): **two lcores**, mirroring a real serving
host's split between a NIC polling thread and an accelerator engine —

* lcore 0 — *harvest*: polls every RX queue, parses serving frames into
  application state (request/KV reassembly), charged at the PMD cost model;
* lcore 1 — *engine*: the continuous-batching iteration loop.  Starting an
  iteration charges ``overhead + ns_per_token·batch_tokens`` to the lcore's
  busy window, so the cluster event loop next wakes the engine exactly at
  iteration completion — queueing delay and compute time land in measured
  TTFT/TPOT with no extra machinery.

The balancer is a single-lcore forwarding stack: it rewrites each request
frame's flow dst_ip to the chosen prefill replica (zero-copy, in its own
arena) and pins a decode replica in the header's aux word.

A stack built from the registry alone is *unwired* (it knows no peers); it
drops every frame it harvests and counts it, so serving kinds degrade
cleanly in single-host testbeds (the engine-fallback taxonomy tests rely on
this).  :func:`wire_serving` — called by ``Cluster.build`` — installs the
:class:`~repro_torch.serving.config.ServingConfig`, role ips, and policy state.

Own copy, in the PyTorch port, of ``src/repro/serving/stacks.py``: the same
numpy and plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ethdev import EthDev
from repro_torch.core.netstack import Lcore, NetworkStack, ServerStats
from repro_torch.exp.testbed import register_stack

from .config import ServingConfig
from .protocol import (MSG_FIRST_TOKEN, MSG_KV_SEG, MSG_REQUEST, MSG_TOKEN,
                       build_frame, is_serving_frame, read_header, set_aux,
                       set_dst_ip)


class _ServingStackBase(NetworkStack):
    """Shared harvest/emit machinery for the serving node stacks."""

    _HARVEST, _ENGINE = 0, 1

    def __init__(self, port, burst_size: int = 32):
        super().__init__([port], n_lcores=1, burst_size=burst_size)
        all_queues = [(0, qi) for qi in range(port.n_queues)]
        self.lcores = [Lcore(self._HARVEST, all_queues, burst_size),
                       Lcore(self._ENGINE, [], burst_size)]
        self.port = port
        self.burst_size = burst_size
        self.serving: Optional[ServingConfig] = None
        self.node_ip = 0
        self._seq = 0
        self._tx_rr = 0
        # counters every role shares
        self.non_serving_drops = 0   # frames without the serving header
        self.unwired_drops = 0       # frames seen before wire_serving
        self.tx_alloc_failures = 0   # node arena exhausted on emit
        self.tx_ring_drops = 0       # TX descriptor ring full on emit

    # -- lcore dispatch --------------------------------------------------------
    def run_lcore(self, lcore: Lcore) -> int:
        if lcore.lcore_id == self._HARVEST:
            return self._harvest_pass(lcore)
        return self._engine_step()

    def _harvest_pass(self, lcore: Lcore) -> int:
        total = 0
        for pi, qi in lcore.assignments:
            qstats = self.queue_stats[(pi, qi)]
            slots, lengths = self.port.rx_burst(qi, lcore.burst_size)
            qstats.poll_iterations += 1
            n = len(slots)
            if n == 0:
                qstats.empty_polls += 1
                continue
            qstats.record_burst(n)
            qstats.rx_packets += n
            qstats.rx_bytes += int(lengths.sum())
            for k in range(n):
                slot = int(slots[k])
                frame = self.port.pool.view(slot, int(lengths[k]))
                self._consume(frame)
                self.port.pool.free(slot)
            if self.clock is not None:
                self.charge_ns(self.sim_cost.pmd_burst_ns(n))
            total += n
        return total

    def _consume(self, frame: np.ndarray) -> None:
        """Parse one harvested frame into application state (frame bytes are
        only valid for the duration of the call)."""
        if not is_serving_frame(frame):
            self.non_serving_drops += 1
            return
        if self.serving is None:
            self.unwired_drops += 1
            return
        self._on_serving_frame(frame)

    def _on_serving_frame(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def _engine_step(self) -> int:
        return 0  # balancer has no engine; prefill/decode override

    # -- emission --------------------------------------------------------------
    def _emit(self, *, size: int, dst_ip: int, msg: int, req_id: int,
              seg: int = 0, seg_count: int = 1, prompt_tokens: int = 0,
              output_tokens: int = 0, aux: int = 0, last: bool = False) -> bool:
        """Format one serving frame in the node arena and post it on a TX
        queue (round-robin); the cluster drains TX onto the fabric."""
        pool = self.port.pool
        slot = pool.alloc()
        if slot is None:
            self.tx_alloc_failures += 1
            return False
        build_frame(pool.arena[slot], size=size, seq=self._seq,
                    src_ip=self.node_ip, dst_ip=dst_ip,
                    stamp_ns=self._poll_now_ns, msg=msg, req_id=req_id,
                    seg=seg, seg_count=seg_count, prompt_tokens=prompt_tokens,
                    output_tokens=output_tokens, aux=aux, last=last)
        self._seq += 1
        pool.lengths[slot] = size
        q = self._tx_rr % self.port.n_queues
        self._tx_rr += 1
        if not self.port.tx_queues[q].post(slot, size):
            pool.free(slot)
            self.tx_ring_drops += 1
            return False
        self.queue_stats[(0, q)].tx_packets += 1
        return True

    def _base_extras(self, role: str) -> Dict[str, float]:
        return {
            f"{role}_non_serving_drops": float(self.non_serving_drops),
            f"{role}_unwired_drops": float(self.unwired_drops),
            f"{role}_tx_alloc_failures": float(self.tx_alloc_failures),
            f"{role}_tx_ring_drops": float(self.tx_ring_drops),
        }


class BalancerServer(_ServingStackBase):
    """The flexlb-style front door: routes each request flow to a prefill
    replica and pins a decode replica for its KV cache + token stream.

    Policies (per request, all deterministic):

    * ``round_robin`` — cycle the prefill replicas;
    * ``least_loaded`` — the replica with the fewest queued-or-running
      prompt tokens (an in-fabric oracle: the balancer reads replica queue
      depths with zero staleness — the idealized upper bound a real
      heartbeat-based flexlb approximates);
    * ``weighted`` — smooth weighted round-robin over
      ``ServingConfig.prefill_weights`` (weight 0 excludes a replica).

    Decode replicas are pinned round-robin over the healthy set; after
    ``fail_at_ns`` the failed replica is withdrawn for *new* requests
    (in-flight requests pinned to it strand — the failover observable).
    """

    def __init__(self, port, burst_size: int = 32):
        super().__init__(port, burst_size)
        self.prefill_ips: List[int] = []
        self.decode_ips: List[int] = []
        self.prefill_servers: List["PrefillServer"] = []
        self.weights: List[int] = []
        self._wrr_current: List[int] = []
        self._rr_prefill = 0
        self._rr_decode = 0
        self.fail_decode_ip: Optional[int] = None
        self.fail_at_ns: Optional[int] = None
        # req_id -> (prefill_ip, decode_ip) while the request flow is in flight
        self._route: Dict[int, Tuple[int, int]] = {}
        self.requests_routed = 0
        self.frames_forwarded = 0
        self.per_prefill_requests: List[int] = []

    def wire(self, serving: ServingConfig, node_ip: int,
             prefill_ips: Sequence[int], decode_ips: Sequence[int],
             prefill_servers: Sequence["PrefillServer"]) -> None:
        self.serving = serving
        self.node_ip = node_ip
        self.prefill_ips = list(prefill_ips)
        self.decode_ips = list(decode_ips)
        self.prefill_servers = list(prefill_servers)
        self.weights = (list(serving.prefill_weights)
                        if serving.prefill_weights is not None
                        else [1] * len(self.prefill_ips))
        self._wrr_current = [0] * len(self.prefill_ips)
        self.per_prefill_requests = [0] * len(self.prefill_ips)
        if serving.fail_node:
            self.fail_decode_ip = decode_ips[
                serving.decode.index(serving.fail_node)]
            self.fail_at_ns = serving.fail_at_ns()

    # -- policy ----------------------------------------------------------------
    def _pick_prefill(self) -> int:
        s = self.serving
        if s.policy == "least_loaded" and self.prefill_servers:
            loads = [srv.queued_tokens for srv in self.prefill_servers]
            return int(np.argmin(loads))  # ties -> lowest index
        if s.policy == "weighted":
            # smooth weighted round-robin (nginx): deterministic, spreads
            # picks evenly at every prefix of the sequence
            total = sum(self.weights)
            for i, w in enumerate(self.weights):
                self._wrr_current[i] += w
            best = max(range(len(self.weights)),
                       key=lambda i: (self._wrr_current[i], -i))
            self._wrr_current[best] -= total
            return best
        i = self._rr_prefill % len(self.prefill_ips)
        self._rr_prefill += 1
        return i

    def _pick_decode(self, now_ns: int) -> int:
        healthy = [ip for ip in self.decode_ips
                   if not (self.fail_at_ns is not None
                           and now_ns >= self.fail_at_ns
                           and ip == self.fail_decode_ip)]
        if not healthy:
            healthy = self.decode_ips  # nothing left: route and strand
        ip = healthy[self._rr_decode % len(healthy)]
        self._rr_decode += 1
        return ip

    # -- dataplane -------------------------------------------------------------
    def _on_serving_frame(self, frame: np.ndarray) -> None:
        hdr = read_header(frame)
        if hdr.msg != MSG_REQUEST:
            self.non_serving_drops += 1
            return
        route = self._route.get(hdr.req_id)
        if route is None:
            pi = self._pick_prefill()
            decode_ip = self._pick_decode(self._poll_now_ns)
            route = (self.prefill_ips[pi], decode_ip)
            self._route[hdr.req_id] = route
            self.per_prefill_requests[pi] += 1
            self.requests_routed += 1
        if hdr.last:
            self._route.pop(hdr.req_id, None)
        prefill_ip, decode_ip = route
        # zero-copy forward: rewrite dst + pin the decode replica, then
        # re-emit the same bytes from this node's arena
        out = frame.copy()
        set_dst_ip(out, prefill_ip)
        set_aux(out, decode_ip)
        self._forward(out)

    def _forward(self, frame: np.ndarray) -> None:
        pool = self.port.pool
        slot = pool.alloc()
        if slot is None:
            self.tx_alloc_failures += 1
            return
        n = len(frame)
        pool.arena[slot, :n] = frame
        pool.lengths[slot] = n
        q = self._tx_rr % self.port.n_queues
        self._tx_rr += 1
        if not self.port.tx_queues[q].post(slot, n):
            pool.free(slot)
            self.tx_ring_drops += 1
            return
        self.queue_stats[(0, q)].tx_packets += 1
        self.frames_forwarded += 1

    def extras(self) -> Dict[str, float]:
        out = self._base_extras("lb")
        out["lb_requests_routed"] = float(self.requests_routed)
        out["lb_frames_forwarded"] = float(self.frames_forwarded)
        for i, c in enumerate(self.per_prefill_requests):
            out[f"lb_prefill{i}_requests"] = float(c)
        return out


class _PendingRequest:
    __slots__ = ("req_id", "client_ip", "decode_ip", "prompt_tokens",
                 "output_tokens", "frames_seen")

    def __init__(self, req_id: int, client_ip: int, decode_ip: int,
                 prompt_tokens: int, output_tokens: int):
        self.req_id = req_id
        self.client_ip = client_ip
        self.decode_ip = decode_ip
        self.prompt_tokens = prompt_tokens
        self.output_tokens = output_tokens
        self.frames_seen = 0


class PrefillServer(_ServingStackBase):
    """Prefill replica: reassembles request flows, runs continuous-batching
    prefill iterations, and on completion emits the first token to the
    client plus the KV-cache elephant flow to the pinned decode replica."""

    def __init__(self, port, burst_size: int = 32):
        super().__init__(port, burst_size)
        self.queue: Deque[_PendingRequest] = deque()
        self._reasm: Dict[int, _PendingRequest] = {}
        self._batch: Optional[List[_PendingRequest]] = None
        self._batch_done_ns = 0
        self.queued_tokens = 0  # queued + running prompt tokens (lb oracle)
        self.requests_in = 0
        self.batches = 0
        self.batch_tokens_total = 0
        self.queue_high = 0
        self.first_tokens_sent = 0
        self.kv_segments_sent = 0

    def wire(self, serving: ServingConfig, node_ip: int) -> None:
        self.serving = serving
        self.node_ip = node_ip

    def _on_serving_frame(self, frame: np.ndarray) -> None:
        hdr = read_header(frame)
        if hdr.msg != MSG_REQUEST:
            self.non_serving_drops += 1
            return
        st = self._reasm.get(hdr.req_id)
        if st is None:
            from repro_torch.core.packet import read_flow
            src_ip, _dst, _sp, _dp = read_flow(frame)
            st = _PendingRequest(hdr.req_id, src_ip, hdr.aux,
                                 hdr.prompt_tokens, hdr.output_tokens)
            self._reasm[hdr.req_id] = st
        st.frames_seen += 1
        if st.frames_seen >= hdr.seg_count:
            del self._reasm[hdr.req_id]
            self.queue.append(st)
            self.queued_tokens += st.prompt_tokens
            self.requests_in += 1
            self.queue_high = max(self.queue_high, len(self.queue))

    def _engine_step(self) -> int:
        if self.serving is None:
            return 0
        now = self._poll_now_ns
        moved = 0
        if self._batch is not None and now >= self._batch_done_ns:
            for req in self._batch:
                self._complete(req)
            moved += len(self._batch)
            self._batch = None
        if self._batch is None and self.queue:
            s = self.serving
            batch: List[_PendingRequest] = []
            tokens = 0
            while self.queue and len(batch) < s.max_batch_requests:
                nxt = self.queue[0]
                if batch and tokens + nxt.prompt_tokens > s.max_batch_tokens:
                    break
                batch.append(self.queue.popleft())
                tokens += nxt.prompt_tokens
            iter_ns = (s.prefill_overhead_ns
                       + tokens * s.resolved_prefill_ns_per_token())
            self.charge_ns(iter_ns)
            self._batch = batch
            self._batch_done_ns = now + int(iter_ns)
            self.batches += 1
            self.batch_tokens_total += tokens
            moved += len(batch)
        return moved

    def _complete(self, req: _PendingRequest) -> None:
        s = self.serving
        self.queued_tokens -= req.prompt_tokens
        # first token home (TTFT stops here — it never waits on the KV path)
        if self._emit(size=s.token_frame_bytes, dst_ip=req.client_ip,
                      msg=MSG_FIRST_TOKEN, req_id=req.req_id, seg=0,
                      seg_count=req.output_tokens,
                      prompt_tokens=req.prompt_tokens,
                      output_tokens=req.output_tokens,
                      last=(req.output_tokens <= 1)):
            self.first_tokens_sent += 1
        if req.output_tokens <= 1:
            return  # single-token request: no decode phase, no KV transfer
        # KV-cache elephant flow to the pinned decode replica
        n_segs = s.kv_segments(req.prompt_tokens)
        for seg in range(n_segs):
            if self._emit(size=s.kv_segment_bytes, dst_ip=req.decode_ip,
                          msg=MSG_KV_SEG, req_id=req.req_id, seg=seg,
                          seg_count=n_segs, prompt_tokens=req.prompt_tokens,
                          output_tokens=req.output_tokens, aux=req.client_ip,
                          last=(seg == n_segs - 1)):
                self.kv_segments_sent += 1

    def extras(self) -> Dict[str, float]:
        out = self._base_extras("prefill")
        out.update({
            "prefill_requests_in": float(self.requests_in),
            "prefill_batches": float(self.batches),
            "prefill_batch_tokens": float(self.batch_tokens_total),
            "prefill_queue_high": float(self.queue_high),
            "prefill_first_tokens": float(self.first_tokens_sent),
            "prefill_kv_segments": float(self.kv_segments_sent),
            "prefill_reasm_pending": float(len(self._reasm)),
        })
        return out


class DecodeServer(_ServingStackBase):
    """Decode replica: reassembles KV elephant flows, then streams one output
    token per continuous-batching iteration per running request.

    Failover: after ``fail_at_ns`` (wired for the configured ``fail_node``
    only) the engine stops and arriving frames are dropped — requests pinned
    here strand, which the client reports as incomplete."""

    def __init__(self, port, burst_size: int = 32):
        super().__init__(port, burst_size)
        self._reasm: Dict[int, Tuple[_PendingRequest, int]] = {}
        self.pending: Deque[_PendingRequest] = deque()
        self.running: List[_PendingRequest] = []
        self._emitted: Dict[int, int] = {}  # req_id -> tokens emitted so far
        self._iter_busy = False
        self._iter_done_ns = 0
        self.fail_at_ns: Optional[int] = None
        self.kv_segments_in = 0
        self.requests_admitted = 0
        self.iterations = 0
        self.tokens_out = 0
        self.requests_done = 0
        self.running_high = 0
        self.failed_drops = 0      # frames discarded after the failure time
        self.stranded_requests = 0  # running/pending abandoned at failure

    def wire(self, serving: ServingConfig, node_ip: int,
             fail_at_ns: Optional[int] = None) -> None:
        self.serving = serving
        self.node_ip = node_ip
        self.fail_at_ns = fail_at_ns

    def _failed(self, now_ns: int) -> bool:
        return self.fail_at_ns is not None and now_ns >= self.fail_at_ns

    def _on_serving_frame(self, frame: np.ndarray) -> None:
        if self._failed(self._poll_now_ns):
            self.failed_drops += 1
            return
        hdr = read_header(frame)
        if hdr.msg != MSG_KV_SEG:
            self.non_serving_drops += 1
            return
        self.kv_segments_in += 1
        entry = self._reasm.get(hdr.req_id)
        if entry is None:
            req = _PendingRequest(hdr.req_id, hdr.aux, self.node_ip,
                                  hdr.prompt_tokens, hdr.output_tokens)
            entry = (req, 0)
        req, seen = entry
        seen += 1
        if seen >= hdr.seg_count:
            self._reasm.pop(hdr.req_id, None)
            self.pending.append(req)
        else:
            self._reasm[hdr.req_id] = (req, seen)

    def _engine_step(self) -> int:
        if self.serving is None:
            return 0
        now = self._poll_now_ns
        if self._failed(now):
            if self.running or self.pending:
                self.stranded_requests += len(self.running) + len(self.pending)
                self.running = []
                self.pending.clear()
                self._iter_busy = False
            return 0
        s = self.serving
        moved = 0
        if self._iter_busy and now >= self._iter_done_ns:
            self._iter_busy = False
            still: List[_PendingRequest] = []
            for req in self.running:
                # token 0 came from prefill; we stream 1..output_tokens-1
                emitted = self._emitted.get(req.req_id, 1) + 1
                done = emitted >= req.output_tokens
                if self._emit(size=s.token_frame_bytes, dst_ip=req.client_ip,
                              msg=MSG_TOKEN, req_id=req.req_id,
                              seg=emitted - 1, seg_count=req.output_tokens,
                              prompt_tokens=req.prompt_tokens,
                              output_tokens=req.output_tokens, last=done):
                    self.tokens_out += 1
                moved += 1
                if done:
                    self._emitted.pop(req.req_id, None)
                    self.requests_done += 1
                else:
                    self._emitted[req.req_id] = emitted
                    still.append(req)
            self.running = still
        if not self._iter_busy:
            while self.pending and len(self.running) < s.decode_max_batch_requests:
                req = self.pending.popleft()
                self._emitted[req.req_id] = 1
                self.running.append(req)
                self.requests_admitted += 1
                moved += 1
            self.running_high = max(self.running_high, len(self.running))
            if self.running:
                iter_ns = (s.resolved_decode_overhead_ns()
                           + len(self.running) * s.resolved_decode_ns_per_token())
                self.charge_ns(iter_ns)
                self._iter_busy = True
                self._iter_done_ns = now + int(iter_ns)
                self.iterations += 1
        return moved

    def extras(self) -> Dict[str, float]:
        out = self._base_extras("decode")
        out.update({
            "decode_kv_segments_in": float(self.kv_segments_in),
            "decode_requests_admitted": float(self.requests_admitted),
            "decode_iterations": float(self.iterations),
            "decode_tokens_out": float(self.tokens_out),
            "decode_requests_done": float(self.requests_done),
            "decode_running_high": float(self.running_high),
            "decode_reasm_pending": float(len(self._reasm)),
            "decode_failed_drops": float(self.failed_drops),
            "decode_stranded_requests": float(self.stranded_requests),
        })
        return out


# -- registry ------------------------------------------------------------------
@register_stack("balancer")
def _build_balancer(cfg, devs: Sequence[EthDev]) -> NetworkStack:
    return BalancerServer(devs[0], burst_size=cfg.burst_size)


@register_stack("prefill")
def _build_prefill(cfg, devs: Sequence[EthDev]) -> NetworkStack:
    return PrefillServer(devs[0], burst_size=cfg.burst_size)


@register_stack("decode")
def _build_decode(cfg, devs: Sequence[EthDev]) -> NetworkStack:
    return DecodeServer(devs[0], burst_size=cfg.burst_size)


def wire_serving(serving: ServingConfig, nodes_by_name: Dict[str, object]) -> None:
    """Install role wiring on a built cluster's serving stacks (called by
    ``Cluster.build``): resolved ips, policy state, and the failover clock.
    ``nodes_by_name`` maps node name -> the builder's Node (needs ``.ip`` and
    ``.server``)."""

    def node(name: str):
        return nodes_by_name[name]

    prefill_nodes = [node(n) for n in serving.prefill]
    decode_nodes = [node(n) for n in serving.decode]
    lb = node(serving.balancer)
    for n in prefill_nodes:
        n.server.wire(serving, n.ip)
    fail_at = serving.fail_at_ns()
    for n in decode_nodes:
        n.server.wire(serving, n.ip,
                      fail_at_ns=(fail_at if n.cfg.name == serving.fail_node
                                  else None))
    lb.server.wire(serving, lb.ip,
                   prefill_ips=[n.ip for n in prefill_nodes],
                   decode_ips=[n.ip for n in decode_nodes],
                   prefill_servers=[n.server for n in prefill_nodes])
