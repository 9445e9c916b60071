"""Serving wire protocol: an application header in the frame payload.

Serving frames are ordinary fabric frames — the flow 4-tuple at
``FLOW_OFFSET`` still drives switch routing and RSS steering, the seq and
timestamp words are where every workload puts them — with an application
header in the payload region (offset 42, right after the flow tuple):

====== ====== =============================================================
offset size   field
====== ====== =============================================================
42     2      magic (LE) — ``MAGIC``; anything else is not a serving frame
44     1      msg type — REQUEST / FIRST_TOKEN / KV_SEG / TOKEN
45     1      flags — bit0: last frame of its flow (request/KV/token stream)
46     4      request id (LE) — globally unique across clients
50     4      segment index (LE) — request frame / KV segment / token index
54     4      segment count (LE) — total frames in this frame's flow
58     4      prompt tokens (LE)
62     4      output tokens (LE)
66     4      aux (LE) — REQUEST: decode-replica ip pinned by the balancer
              (0 until routed); KV_SEG: the client ip the decode node
              streams tokens to
====== ====== =============================================================

Message flow for one request::

    client --REQUEST*n--> balancer --(rewrite dst, pin decode)--> prefill
    prefill --FIRST_TOKEN--> client          (TTFT measured here)
    prefill --KV_SEG*m--> decode             (the elephant flow)
    decode  --TOKEN*k--> client              (TPOT measured here)

All helpers operate on any uint8 buffer (arena views and standalone
arrays alike).

Own copy, in the PyTorch port, of ``src/repro/serving/protocol.py``: the same
numpy and plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.packet import ETHERTYPE, write_flow, write_seq

PAYLOAD_OFFSET = 42  # FLOW_OFFSET + FLOW_SIZE
MAGIC = 0x5E15
HEADER_END = 70

MSG_REQUEST = 1      # client -> balancer -> prefill (prompt shard)
MSG_FIRST_TOKEN = 2  # prefill -> client (prefill done; token 0)
MSG_KV_SEG = 3       # prefill -> decode (KV-cache transfer segment)
MSG_TOKEN = 4        # decode -> client (output token i >= 1)

FLAG_LAST = 0x01

SERVING_DST_PORT = 8000  # flow dst_port for all serving traffic


@dataclass
class ServingHeader:
    msg: int
    flags: int
    req_id: int
    seg: int
    seg_count: int
    prompt_tokens: int
    output_tokens: int
    aux: int

    @property
    def last(self) -> bool:
        return bool(self.flags & FLAG_LAST)


def _put_u32(buf: np.ndarray, off: int, value: int) -> None:
    buf[off:off + 4] = np.frombuffer(
        int(value).to_bytes(4, "little"), dtype=np.uint8)


def _get_u32(buf: np.ndarray, off: int) -> int:
    return int.from_bytes(bytes(buf[off:off + 4]), "little")


def is_serving_frame(buf: np.ndarray) -> bool:
    return (len(buf) >= HEADER_END
            and int.from_bytes(bytes(buf[42:44]), "little") == MAGIC)


def write_header(buf: np.ndarray, *, msg: int, req_id: int, seg: int = 0,
                 seg_count: int = 1, prompt_tokens: int = 0,
                 output_tokens: int = 0, aux: int = 0,
                 last: bool = False) -> None:
    buf[42:44] = np.frombuffer(MAGIC.to_bytes(2, "little"), dtype=np.uint8)
    buf[44] = msg
    buf[45] = FLAG_LAST if last else 0
    _put_u32(buf, 46, req_id)
    _put_u32(buf, 50, seg)
    _put_u32(buf, 54, seg_count)
    _put_u32(buf, 58, prompt_tokens)
    _put_u32(buf, 62, output_tokens)
    _put_u32(buf, 66, aux)


def read_header(buf: np.ndarray) -> ServingHeader:
    return ServingHeader(
        msg=int(buf[44]), flags=int(buf[45]),
        req_id=_get_u32(buf, 46), seg=_get_u32(buf, 50),
        seg_count=_get_u32(buf, 54), prompt_tokens=_get_u32(buf, 58),
        output_tokens=_get_u32(buf, 62), aux=_get_u32(buf, 66))


def set_dst_ip(buf: np.ndarray, dst_ip: int) -> None:
    """Rewrite the flow dst_ip in place (the balancer's forwarding op)."""
    buf[34:38] = np.frombuffer(
        int(dst_ip).to_bytes(4, "big"), dtype=np.uint8)


def set_aux(buf: np.ndarray, aux: int) -> None:
    """Rewrite the aux word in place (the balancer pins the decode ip)."""
    _put_u32(buf, 66, aux)


def build_frame(buf: np.ndarray, *, size: int, seq: int, src_ip: int,
                dst_ip: int, stamp_ns: int, msg: int, req_id: int,
                seg: int = 0, seg_count: int = 1, prompt_tokens: int = 0,
                output_tokens: int = 0, aux: int = 0,
                last: bool = False) -> None:
    """Format one complete serving frame into ``buf[:size]``.

    The flow src_port carries ``req_id`` entropy so multi-queue RSS spreads
    concurrent requests across a node's queues; dst_port is the serving
    port.  ``buf`` must hold at least ``size`` >= HEADER_END bytes.
    """
    if size < HEADER_END:
        raise ValueError(f"serving frame size {size} < header end {HEADER_END}")
    frame = buf[:size]
    frame[0:6] = 0x0E   # serving dst "mac"
    frame[6:12] = 0x0A  # serving src "mac"
    frame[12] = (ETHERTYPE >> 8) & 0xFF
    frame[13] = ETHERTYPE & 0xFF
    write_seq(frame, seq)
    # ts word (offset 22): the emission stamp, for debuggability — SLO
    # accounting happens at the client on arrival times
    frame[22:30] = np.frombuffer(
        int(stamp_ns).to_bytes(8, "little"), dtype=np.uint8)
    write_flow(frame, src_ip, dst_ip, 1024 + (req_id % 60000),
               SERVING_DST_PORT)
    frame[HEADER_END:size] = 0
    write_header(frame, msg=msg, req_id=req_id, seg=seg, seg_count=seg_count,
                 prompt_tokens=prompt_tokens, output_tokens=output_tokens,
                 aux=aux, last=last)
