"""Request generation + the client-side SLO measurement point.

:class:`RequestGenerator` turns a :class:`~repro_torch.serving.config.ServingConfig`
into analytic per-request arrival times (reusing
:meth:`~repro_torch.core.loadgen.TrafficPattern.emission_schedule`, so poisson /
bursty / uniform arrivals behave exactly like the echo workloads') plus
per-request prompt/output token draws from the
:class:`~repro_torch.serving.config.RequestMixConfig` distributions.

:class:`ServingClient` is the fabric-attached user population for one switch
port: it emits each due request as a multi-frame flow addressed to the
balancer, tracks per-request state as token frames come home, and records
the serving SLOs in virtual ns:

* **TTFT** — time to first token: first-token arrival minus request
  emission (includes balancer hop, prefill queueing and prefill compute);
* **TPOT** — time per output token: the mean inter-token gap over the
  decode token stream;
* **E2E**  — request completion latency (the RunReport's latency column).

Everything is deterministic per (config, seed): schedules and token draws
are precomputed, and arrival processing is pure bookkeeping.

Own copy, in the PyTorch port, of ``src/repro/serving/requestgen.py``: the same
numpy and plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.loadgen import TrafficPattern
from repro_torch.core.telemetry import LatencyRecorder, ThroughputMeter

from .config import ServingConfig
from .protocol import (MSG_FIRST_TOKEN, MSG_REQUEST, MSG_TOKEN, build_frame,
                       is_serving_frame, read_header)

# request ids: client g owns [(g+1) << 22, (g+2) << 22) — globally unique
# for up to ~4M requests per client and 1023 clients in a u32
REQ_ID_STRIDE = 1 << 22


class RequestGenerator:
    """Deterministic request stream: arrival times + token-length draws."""

    def __init__(self, serving: ServingConfig, seed: int):
        self.serving = serving
        self.seed = int(seed)
        # offered QPS -> the pattern's packets-per-second identity:
        # pps == rate_gbps * 1e9 / 8 / packet_size
        rate_gbps = (serving.qps * serving.request_frame_bytes * 8) / 1e9
        self.pattern = TrafficPattern(
            rate_gbps=rate_gbps, packet_size=serving.request_frame_bytes,
            kind=serving.arrival_kind, burst_len=serving.arrival_burst_len,
            seed=self.seed)

    def generate(self, duration_ns: int):
        """(times int64[n], prompt_tokens int64[n], output_tokens int64[n])."""
        rng = np.random.default_rng(self.seed)
        times, _sizes = self.pattern.emission_schedule(duration_ns, rng)
        prompts, outputs = self.serving.mix.sample(rng, len(times))
        return times, prompts, outputs


@dataclass
class _RequestState:
    emit_ns: int
    prompt_tokens: int
    output_tokens: int
    tokens_received: int = 0
    first_ns: Optional[int] = None
    last_ns: Optional[int] = None
    done: bool = False


@dataclass
class ServingClient:
    """One client population on one switch port: emits requests, measures
    SLOs on the token stream coming back."""

    serving: ServingConfig
    client_index: int
    src_ip: int
    balancer_ip: int
    seed: int

    requests_sent: int = 0
    requests_completed: int = 0
    frames_sent: int = 0
    tokens_received: int = 0
    stray_frames: int = 0  # non-serving or unknown-request arrivals

    ttft: LatencyRecorder = field(default_factory=LatencyRecorder)
    tpot: LatencyRecorder = field(default_factory=LatencyRecorder)
    e2e: LatencyRecorder = field(default_factory=LatencyRecorder)
    meter: ThroughputMeter = field(default_factory=ThroughputMeter)

    def __post_init__(self) -> None:
        self.gen = RequestGenerator(self.serving, self.seed)
        self._req: Dict[int, _RequestState] = {}
        self._times = np.empty(0, dtype=np.int64)
        self._prompts = np.empty(0, dtype=np.int64)
        self._outputs = np.empty(0, dtype=np.int64)
        self._req_id_base = (self.client_index + 1) * REQ_ID_STRIDE

    # -- emission --------------------------------------------------------------
    def plan(self, duration_ns: int, start_ns: int) -> np.ndarray:
        """Precompute this run's request stream; returns the arrival times
        (already offset to ``start_ns``) the driver walks a cursor over."""
        times, prompts, outputs = self.gen.generate(duration_ns)
        self._times = times + start_ns if len(times) else times
        self._prompts, self._outputs = prompts, outputs
        if len(self._times):
            self.meter.open_window(int(self._times[0]))
        return self._times

    def emit_request(self, i: int, t_emit: int) -> List[np.ndarray]:
        """Materialize request ``i`` of the plan as its frame flow (all
        frames enter the client's uplink at ``t_emit``; the wire's FIFO
        serialization spaces them)."""
        s = self.serving
        prompt = int(self._prompts[i])
        output = int(self._outputs[i])
        req_id = self._req_id_base + i
        n_frames = s.request_frames(prompt)
        frames: List[np.ndarray] = []
        for seg in range(n_frames):
            buf = np.zeros(s.request_frame_bytes, dtype=np.uint8)
            build_frame(buf, size=s.request_frame_bytes,
                        seq=self.frames_sent, src_ip=self.src_ip,
                        dst_ip=self.balancer_ip, stamp_ns=t_emit,
                        msg=MSG_REQUEST, req_id=req_id, seg=seg,
                        seg_count=n_frames, prompt_tokens=prompt,
                        output_tokens=output, last=(seg == n_frames - 1))
            self.frames_sent += 1
            frames.append(buf)
        self._req[req_id] = _RequestState(
            emit_ns=t_emit, prompt_tokens=prompt, output_tokens=output)
        self.requests_sent += 1
        return frames

    # -- arrivals (the switch egress sink calls this) --------------------------
    def complete_frame(self, frame: np.ndarray, t_ns: int) -> None:
        if not is_serving_frame(frame):
            self.stray_frames += 1
            return
        hdr = read_header(frame)
        st = self._req.get(hdr.req_id)
        if st is None or st.done or hdr.msg not in (MSG_FIRST_TOKEN, MSG_TOKEN):
            self.stray_frames += 1
            return
        self.meter.on_packet(t_ns, len(frame))
        st.tokens_received += 1
        self.tokens_received += 1
        if hdr.msg == MSG_FIRST_TOKEN and st.first_ns is None:
            st.first_ns = t_ns
            self.ttft.record(t_ns - st.emit_ns)
        st.last_ns = t_ns
        if st.tokens_received >= st.output_tokens:
            st.done = True
            self.requests_completed += 1
            self.e2e.record(t_ns - st.emit_ns)
            if st.first_ns is not None and st.output_tokens > 1:
                self.tpot.record(
                    (st.last_ns - st.first_ns) / (st.output_tokens - 1))

    # -- accounting ------------------------------------------------------------
    @property
    def requests_incomplete(self) -> int:
        return self.requests_sent - self.requests_completed

    def extras(self) -> Dict[str, float]:
        return {
            "requests_sent": float(self.requests_sent),
            "requests_completed": float(self.requests_completed),
            "tokens_received": float(self.tokens_received),
            "stray_frames": float(self.stray_frames),
        }
