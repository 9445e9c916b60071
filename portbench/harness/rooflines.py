"""A kernel op's share of its roofline in a traced run: the sum of each
call's bound (its work from its argument shapes, ``work.py``) over the
device time of the kernels the profiler links to those calls (both from
the traced run's attribution profile)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from . import work

ITEMSIZE = {"bfloat16": 2, "half": 2, "float16": 2, "float": 4, "float32": 4}


def itemsize(dtypes, model: dict) -> int:
    """The first argument's bytes an element, from the profiler's record of
    its dtype where it kept one, else the configuration's compute dtype."""
    if dtypes and dtypes[0]:
        name = str(dtypes[0]).split("::")[-1].lower()
        if name in ITEMSIZE:
            return ITEMSIZE[name]
    return ITEMSIZE[model["compute_dtype"]]


def _arg(scalars, i: int, default):
    return scalars[i] if len(scalars) > i and scalars[i] is not None else default


def ssd_forward(shapes, scalars, size: int, model: dict) -> work.Work:
    """repro_torch::ssd_scan_fwd(x, dt, A, Bmat, Cmat, h0, chunk)."""
    B, S, H, P = shapes[0]
    return work.ssd_forward(B, S, H, P, shapes[3][-1], _arg(scalars, 6, model["ssm_chunk"]),
                            size, h0=bool(shapes[5]))


def ssd_backward(shapes, scalars, size: int, model: dict) -> work.Work:
    """repro_torch::ssd_scan_bwd(x, dt, A, Bmat, Cmat, h0, dy, dh_final, chunk, ws)."""
    B, S, H, P = shapes[0]
    return work.ssd_backward(B, S, H, P, shapes[3][-1], _arg(scalars, 8, model["ssm_chunk"]),
                             size, h0=bool(shapes[5]), dh_final=bool(shapes[7]))


def flash_forward(shapes, scalars, size: int, model: dict) -> work.Work:
    """repro_torch::flash_attention_fwd(q, k, v, causal, window, q_offset, scale, with_lse)."""
    return work.flash_forward(shapes[0], shapes[1], size,
                              causal=bool(_arg(scalars, 3, model["causal"])),
                              window=int(_arg(scalars, 4, model["window"])),
                              q_offset=int(_arg(scalars, 5, 0)),
                              with_lse=bool(_arg(scalars, 7, True)))


def flash_backward(shapes, scalars, size: int, model: dict) -> work.Work:
    """repro_torch::flash_attention_bwd(q, k, v, out, lse, dout, causal, window,
    q_offset, scale)."""
    return work.flash_backward(shapes[0], shapes[1], size,
                               causal=bool(_arg(scalars, 6, model["causal"])),
                               window=int(_arg(scalars, 7, model["window"])),
                               q_offset=int(_arg(scalars, 8, 0)))


Bound = Callable[..., work.Work]


def share(trace, ops: Dict[str, Bound], model: dict) -> Optional[float]:
    """Percent of the roofline over the ops named, or None where the trace
    holds no call of them or no device time."""
    if trace is None:
        return None
    bound_s = device_s = 0.0
    for name, fn in ops.items():
        rec = trace.ops.get(name)
        if rec is None or not rec.calls:
            continue
        bound_s += sum(fn(shapes, scalars, itemsize(dtypes, model), model).bound_s()
                       for shapes, scalars, dtypes in rec.args)
        device_s += rec.device_s()
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
