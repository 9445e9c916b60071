"""Production mesh construction (port of ``src/repro/launch/mesh.py``).

Functions, not module-level constants, so that importing this module
touches no process group. Every mesh here is an ``init_device_mesh`` over
the default process group, which the caller sets up (``torchrun`` and
``init_process_group``, or a test's own world). The device type is always
passed in: ``"cuda"`` for the card, ``"cpu"`` for the tests; it is never
found by probing.

The JAX package's ``auto_axis_types_kw`` is a shim over JAX versions that
do or do not have ``AxisType``; a DeviceMesh has no axis types, so it has no
counterpart here.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel.axes import (AxisRules, multi_pod_rules, pure_fsdp_rules,
                                       single_pod_rules)


def make_auto_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str) -> Any:
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group, which must hold exactly ``prod(shape)`` ranks."""
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs {need} ranks; "
                         f"the default process group has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str) -> Any:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device_type)


def rules_for(mesh: Any, layout: str = "tp") -> AxisRules:
    """layout: "tp" (TP over model + FSDP over data, the baseline) or "fsdp"
    (pure 256-way ZeRO-3, single-pod only — multi-pod falls back to tp since
    global_batch 256 cannot split 512 ways)."""
    if "pod" in mesh.mesh_dim_names:
        return multi_pod_rules()
    if layout == "fsdp":
        return pure_fsdp_rules()
    return single_pod_rules()


def make_smoke_mesh(n_devices: int = 1, *, device_type: str) -> Any:
    """A (1, n) ("data", "model") mesh over the default process group of n
    ranks (tests, and the card's one-rank run)."""
    return make_auto_mesh((1, n_devices), ("data", "model"), device_type)
