"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/repro_torch/lib<name>_<hash>.so`` at the repository root,
where ``<hash>`` covers the source, the shared headers and the flags: a
changed source builds anew, an unchanged one is loaded from disk. Nothing is
built when a module is imported; the first launch of a kernel builds it.
``build_all`` starts one ``nvcc`` per source at once, so a cold start costs
about as long as the slowest file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}

# dtype codes of the C launchers (repro::kF32, repro::kBF16 in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                           "built on a machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, writing to a private temp file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, out: Path, proc: subprocess.Popen, tmp: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all(names: List[str]) -> Dict[str, float]:
    """Build every named source that is not built yet, all nvcc runs at once.
    Returns the seconds until each was ready (0.0 for one found on disk)."""
    t0 = time.perf_counter()
    seconds = {name: 0.0 for name in names}
    procs = {name: (library_path(name), *_start(name)) for name in names
             if not library_path(name).exists()}
    for name, (out, proc, tmp) in procs.items():
        _finish(name, out, proc, tmp)
        seconds[name] = time.perf_counter() - t0
    return seconds


def ptxas_report(name: str) -> str:
    """What ptxas says of each kernel of ``csrc/<name>.cu`` (registers,
    spills, shared memory), from an nvcc run with NVCC_FLAGS and
    ``-Xptxas -v`` whose library is thrown away."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(Path(tmp) / f"lib{name}.so"), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``.

    The wrappers fill their outputs through ctypes, so the outputs carry no
    ``grad_fn``: under grad mode, an input that requires grad would silently
    get no gradient through the kernel. Wrappers of kernels without a
    backward (``decode_attention_cuda``) call this before launching; ``None``
    entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel yet (see ROADMAP.md), and its output "
            "would carry no gradient: call it under torch.no_grad() or with "
            "inputs that do not require grad")


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError after launch)."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")


if __name__ == "__main__":
    # python -m repro_torch.kernels._build NAME...: ptxas's report of each
    # named source (on a machine with nvcc)
    import sys
    for arg in sys.argv[1:]:
        print(f"== {arg}.cu\n{ptxas_report(arg)}")
