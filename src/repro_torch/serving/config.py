"""Frozen, declarative LLM-serving configs — pure data, JSON round-trip.

The serving layer turns the fabric's echo workloads into a stateful
application: clients emit *requests* (multi-frame flows), a balancer routes
them across prefill replicas, prefill nodes run continuous-batching
iterations and ship the KV cache to a decode replica as an elephant flow,
and decode nodes stream output tokens back to the client.  Everything the
scenario needs is described here:

* :class:`RequestMixConfig` — the workload: which model architecture
  (``repro_torch.models`` registry id) and the prompt/output token-length
  distributions drawn per request.
* :class:`ServingConfig` — the deployment: node roles, balancer policy,
  offered request rate, continuous-batching limits, the compute cost model
  (derivable from the model config, overridable as data), wire formats for
  request/token/KV-segment frames, and an optional decode-replica failover.

Like every config in :mod:`repro_torch.exp.config`, these are frozen dataclasses
with exact ``to_dict``/``from_dict`` round-trip.  Nothing here imports the
dataplane or the exp layer — :mod:`repro_torch.exp.config` embeds a
``ServingConfig`` inside ``TopologyConfig`` and :mod:`repro_torch.exp.topology`
builds the live objects.

Own copy, in the PyTorch port, of ``src/repro/serving/config.py``: the same
plain Python, with its imports pointing into ``repro_torch``.
:attr:`RequestMixConfig.model` is checked against the port's registry
(:data:`repro_torch.models.registry.ARCHS`), which has the JAX package's ten
archs, and every one derives the same cost figures as the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.loadgen import TRAFFIC_KINDS
from repro_torch.models.registry import ARCHS, get_config

BALANCER_POLICIES = ("round_robin", "least_loaded", "weighted")
TOKEN_DISTS = ("fixed", "exponential", "lognormal")

# serving frames carry an application header after the flow tuple; keep a
# comfortable floor above it (see repro_torch.serving.protocol.HEADER_END == 70)
MIN_SERVING_FRAME = 96


def _plain(value: Any) -> Any:
    if hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


def _to_dict(cfg: Any) -> Dict[str, Any]:
    return {f.name: _plain(getattr(cfg, f.name)) for f in fields(cfg)}


@dataclass(frozen=True)
class RequestMixConfig:
    """The request workload: model architecture + token-length distributions.

    ``model`` is an id from the :mod:`repro_torch.models` registry (e.g.
    ``"llama3.2-3b"``, ``"mixtral-8x7b"``); the serving cost model and the
    KV-cache transfer size derive their defaults from its
    :class:`~repro_torch.models.config.ModelConfig`.  Prompt/output lengths are
    drawn per request: ``fixed`` (the mean, exactly), ``exponential``
    (scale == mean), or ``lognormal`` (mean + coefficient of variation),
    clipped into the configured bounds.
    """

    model: str = "llama3.2-3b"
    prompt_mean_tokens: int = 256
    prompt_dist: str = "lognormal"
    prompt_cv: float = 0.5
    max_prompt_tokens: int = 4096
    output_mean_tokens: int = 8
    output_dist: str = "fixed"
    output_cv: float = 0.5
    min_output_tokens: int = 2
    max_output_tokens: int = 512

    def __post_init__(self) -> None:
        if self.model not in ARCHS:
            raise ValueError(
                f"unknown model {self.model!r}; registry has {sorted(ARCHS)}")
        for d, what in ((self.prompt_dist, "prompt_dist"),
                        (self.output_dist, "output_dist")):
            if d not in TOKEN_DISTS:
                raise ValueError(f"{what} must be one of {TOKEN_DISTS}")
        if self.prompt_mean_tokens < 1 or self.output_mean_tokens < 1:
            raise ValueError("token means must be >= 1")
        if self.prompt_cv < 0 or self.output_cv < 0:
            raise ValueError("coefficients of variation must be >= 0")
        if self.max_prompt_tokens < self.prompt_mean_tokens:
            raise ValueError("max_prompt_tokens < prompt_mean_tokens")
        if not 1 <= self.min_output_tokens <= self.max_output_tokens:
            raise ValueError(
                "need 1 <= min_output_tokens <= max_output_tokens")

    def sample(self, rng, n: int):
        """Draw ``n`` (prompt_tokens, output_tokens) pairs — deterministic
        given the generator state.  Returns two int64 numpy arrays."""
        import numpy as np

        def draw(dist, mean, cv, lo, hi):
            if dist == "fixed" or cv == 0.0:
                vals = np.full(n, mean, dtype=np.float64)
                if dist == "exponential" and cv != 0.0:
                    vals = rng.exponential(mean, size=n)
            elif dist == "exponential":
                vals = rng.exponential(mean, size=n)
            else:  # lognormal parameterized by mean + cv
                sigma2 = math.log(1.0 + cv * cv)
                mu = math.log(mean) - sigma2 / 2.0
                vals = rng.lognormal(mu, math.sqrt(sigma2), size=n)
            return np.clip(np.rint(vals).astype(np.int64), lo, hi)

        prompts = draw(self.prompt_dist, self.prompt_mean_tokens,
                       self.prompt_cv, 1, self.max_prompt_tokens)
        outputs = draw(self.output_dist, self.output_mean_tokens,
                       self.output_cv, self.min_output_tokens,
                       self.max_output_tokens)
        return prompts, outputs

    def to_dict(self) -> Dict[str, Any]:
        return _to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RequestMixConfig":
        return cls(**d)


@dataclass(frozen=True)
class ServingConfig:
    """One disaggregated serving deployment over a ``TopologyConfig``.

    Role wiring: ``balancer``/``prefill``/``decode`` name nodes of the
    enclosing topology; the named nodes' stacks must be the matching
    registered kinds (``"balancer"``/``"prefill"``/``"decode"``).  Clients
    address all requests to the balancer, which rewrites each request flow
    to a prefill replica (``policy``) and pins a decode replica for the
    request's KV cache + token stream.

    Offered load: each client emits ``qps`` requests per second with
    ``arrival_kind`` arrivals (the same analytic schedules
    :meth:`~repro_torch.core.loadgen.TrafficPattern.emission_schedule` gives the
    echo workloads).

    Cost model: per-iteration compute charged to the serving node's engine
    lcore is ``overhead + ns_per_token * batch_tokens``.  ``None`` figures
    derive from the :class:`~repro_torch.models.config.ModelConfig`:

    * ``prefill_ns_per_token`` — 2·active_params FLOPs/token at
      ``hw_tflops`` (compute-bound);
    * ``decode_overhead_ns`` — streaming the weights once per iteration at
      ``hw_hbm_gbps`` GB/s (bandwidth-bound — the continuous-batching
      economics: the overhead amortizes across the running batch);
    * ``decode_ns_per_token`` — the per-request marginal compute, same
      figure as prefill;
    * ``kv_bytes_per_token`` — 2·n_layers·kv_dim·2 bytes (K+V, bf16).
    """

    mix: RequestMixConfig = field(default_factory=RequestMixConfig)
    balancer: str = "lb"
    prefill: Tuple[str, ...] = ("prefill0", "prefill1")
    decode: Tuple[str, ...] = ("decode0", "decode1")
    policy: str = "round_robin"
    prefill_weights: Optional[Tuple[int, ...]] = None
    # offered load, per client
    qps: float = 500.0
    arrival_kind: str = "poisson"
    arrival_burst_len: int = 8
    # continuous batching
    max_batch_tokens: int = 8192
    max_batch_requests: int = 16
    decode_max_batch_requests: int = 64
    # compute cost model (None == derive from the model config)
    prefill_ns_per_token: Optional[int] = None
    prefill_overhead_ns: int = 20_000
    decode_ns_per_token: Optional[int] = None
    decode_overhead_ns: Optional[int] = None
    hw_tflops: float = 200.0
    hw_hbm_gbps: float = 1600.0
    # wire formats
    request_frame_bytes: int = 512
    request_tokens_per_frame: int = 128
    token_frame_bytes: int = 128
    kv_segment_bytes: int = 4096
    kv_bytes_per_token: Optional[int] = None
    # failover: withdraw one decode replica mid-run ("" == no failure)
    fail_node: str = ""
    fail_at_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.balancer or not self.prefill or not self.decode:
            raise ValueError("serving needs a balancer, >=1 prefill and "
                             ">=1 decode node name")
        roles = [self.balancer, *self.prefill, *self.decode]
        if len(set(roles)) != len(roles):
            raise ValueError(f"serving role node names overlap: {roles}")
        if self.policy not in BALANCER_POLICIES:
            raise ValueError(f"policy must be one of {BALANCER_POLICIES}")
        if self.prefill_weights is not None:
            if len(self.prefill_weights) != len(self.prefill):
                raise ValueError(
                    f"prefill_weights has {len(self.prefill_weights)} "
                    f"entries for {len(self.prefill)} prefill nodes")
            if any(w < 0 for w in self.prefill_weights) \
                    or sum(self.prefill_weights) <= 0:
                raise ValueError("prefill_weights must be >= 0, sum > 0")
        if self.qps <= 0:
            raise ValueError("qps must be positive")
        if self.arrival_kind not in TRAFFIC_KINDS:
            raise ValueError(f"arrival_kind must be one of {TRAFFIC_KINDS}")
        if self.arrival_burst_len < 1:
            raise ValueError("arrival_burst_len must be >= 1")
        if self.max_batch_tokens < 1 or self.max_batch_requests < 1 \
                or self.decode_max_batch_requests < 1:
            raise ValueError("batching limits must be >= 1")
        for v, what in ((self.prefill_ns_per_token, "prefill_ns_per_token"),
                        (self.decode_ns_per_token, "decode_ns_per_token"),
                        (self.decode_overhead_ns, "decode_overhead_ns"),
                        (self.kv_bytes_per_token, "kv_bytes_per_token")):
            if v is not None and v < 1:
                raise ValueError(f"{what} must be >= 1 or None")
        if self.prefill_overhead_ns < 0:
            raise ValueError("prefill_overhead_ns must be >= 0")
        if self.hw_tflops <= 0 or self.hw_hbm_gbps <= 0:
            raise ValueError("hardware throughput figures must be positive")
        for v, what in ((self.request_frame_bytes, "request_frame_bytes"),
                        (self.token_frame_bytes, "token_frame_bytes"),
                        (self.kv_segment_bytes, "kv_segment_bytes")):
            if v < MIN_SERVING_FRAME:
                raise ValueError(
                    f"{what}={v} below MIN_SERVING_FRAME={MIN_SERVING_FRAME} "
                    "(serving frames carry an application header)")
        if self.request_tokens_per_frame < 1:
            raise ValueError("request_tokens_per_frame must be >= 1")
        if self.fail_node and self.fail_node not in self.decode:
            raise ValueError(
                f"fail_node {self.fail_node!r} is not a decode node "
                "(failover currently models decode-replica loss)")
        if self.fail_at_s < 0:
            raise ValueError("fail_at_s must be >= 0")

    # -- model-derived defaults ------------------------------------------------
    def model_config(self):
        return get_config(self.mix.model)

    def resolved_prefill_ns_per_token(self) -> int:
        if self.prefill_ns_per_token is not None:
            return self.prefill_ns_per_token
        flops = 2.0 * self.model_config().active_param_count()
        return max(1, int(round(flops / (self.hw_tflops * 1e3))))

    def resolved_decode_ns_per_token(self) -> int:
        if self.decode_ns_per_token is not None:
            return self.decode_ns_per_token
        return self.resolved_prefill_ns_per_token()

    def resolved_decode_overhead_ns(self) -> int:
        if self.decode_overhead_ns is not None:
            return self.decode_overhead_ns
        weight_bytes = 2.0 * self.model_config().active_param_count()
        return max(1, int(round(weight_bytes / self.hw_hbm_gbps)))

    def resolved_kv_bytes_per_token(self) -> int:
        if self.kv_bytes_per_token is not None:
            return self.kv_bytes_per_token
        m = self.model_config()
        return 2 * m.n_layers * m.kv_dim * 2  # K+V, bf16

    def request_frames(self, prompt_tokens: int) -> int:
        """How many request frames carry a prompt of this many tokens."""
        return max(1, math.ceil(prompt_tokens / self.request_tokens_per_frame))

    def kv_segments(self, prompt_tokens: int) -> int:
        """KV-transfer elephant-flow length (frames) for one request."""
        kv_bytes = prompt_tokens * self.resolved_kv_bytes_per_token()
        return max(1, math.ceil(kv_bytes / self.kv_segment_bytes))

    def fail_at_ns(self) -> Optional[int]:
        return int(self.fail_at_s * 1e9) if self.fail_node else None

    # -- round-trip ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingConfig":
        d = dict(d)
        d["mix"] = RequestMixConfig.from_dict(d.get("mix", {}))
        d["prefill"] = tuple(d.get("prefill", ()))
        d["decode"] = tuple(d.get("decode", ()))
        if d.get("prefill_weights") is not None:
            d["prefill_weights"] = tuple(d["prefill_weights"])
        return cls(**d)

    def with_mix(self, **kw: Any) -> "ServingConfig":
        return replace(self, mix=replace(self.mix, **kw))
