"""LLM-inference-serving application layer over the simulated fabric.

Importing this package registers the serving stack kinds (``balancer``,
``prefill``, ``decode``) with the testbed stack registry — ``Cluster.build``
does so when a :class:`~repro_torch.exp.config.TopologyConfig` carries a
:class:`ServingConfig`.

Own copy, in the PyTorch port, of ``src/repro/serving/__init__.py``: the same
plain Python, with its imports pointing into ``repro_torch``.
"""
from .config import (BALANCER_POLICIES, MIN_SERVING_FRAME, TOKEN_DISTS,
                     RequestMixConfig, ServingConfig)
from .protocol import (FLAG_LAST, HEADER_END, MAGIC, MSG_FIRST_TOKEN,
                       MSG_KV_SEG, MSG_REQUEST, MSG_TOKEN, SERVING_DST_PORT,
                       ServingHeader, build_frame, is_serving_frame,
                       read_header, set_aux, set_dst_ip, write_header)
from .requestgen import RequestGenerator, ServingClient
from .stacks import (BalancerServer, DecodeServer, PrefillServer,
                     wire_serving)

__all__ = [
    "BALANCER_POLICIES",
    "TOKEN_DISTS",
    "MIN_SERVING_FRAME",
    "RequestMixConfig",
    "ServingConfig",
    "ServingHeader",
    "MAGIC",
    "HEADER_END",
    "FLAG_LAST",
    "MSG_REQUEST",
    "MSG_FIRST_TOKEN",
    "MSG_KV_SEG",
    "MSG_TOKEN",
    "SERVING_DST_PORT",
    "build_frame",
    "read_header",
    "write_header",
    "is_serving_frame",
    "set_dst_ip",
    "set_aux",
    "RequestGenerator",
    "ServingClient",
    "BalancerServer",
    "PrefillServer",
    "DecodeServer",
    "wire_serving",
]
