"""The port's plain RG-LRU backward on one host, held to JAX's vjp on another.

``tests/test_torch_rglru_bwd.py`` holds the port's plain backward
(``ref.rglru_scan_bwd``) and ``jax.vjp`` of the JAX package's associative
scan to a float64 oracle of the closed form, each within a derived bound, and
to each other within the sum of the two. Where JAX is missing, that test
cannot run; this script splits it across two hosts:

    # where the port runs (no JAX needed): the port's dx, da_log, dh0 on the
    # test's six cases and seed-0 inputs, the oracle and its bounds
    PYTHONPATH=src python tests/rglru_bwd_hosts.py dump OUT.npz

    # where JAX runs: JAX's vjp on the same inputs, and each gradient of the
    # dump held to it within the sum of the two bounds, and to the oracle
    # within one; exit 1 if any element is outside
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rglru_bwd_hosts.py compare OUT.npz

``compare`` prints one JSON line a case and gradient: the largest
|port - JAX| and |port - oracle| over their bounds (at most 1 passes), and
whether the dump's inputs and oracle equal this host's.
"""
import json
import platform
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_rglru_bwd as T  # noqa: E402


def _case_id(case):
    return "-".join(map(str, case))


def dump(path):
    import torch
    out = {"host": np.array(f"{platform.node()} {platform.processor()} torch "
                            f"{torch.__version__}")}
    for case in T.CASES:
        a = T._inputs(case)
        exact, bounds, _ = T._oracle(a)
        for name, g, e, b in zip(T.NAMES, T._plain_bwd(a), exact, bounds):
            if g is None:
                continue
            key = f"{_case_id(case)}/{name}"
            out[f"{key}/port"] = g.detach().float().numpy()
            out[f"{key}/oracle"] = e
            out[f"{key}/bound"] = b
        out[f"{_case_id(case)}/a_log"] = a["a_log"]
    np.savez(path, **out)
    print(f"wrote {len(out)} arrays to {path} ({out['host']})")


def compare(path):
    got = np.load(path)
    print(f"dump from {got['host']}")
    worst = 0.0
    for case in T.CASES:
        a = T._inputs(case)
        cid = _case_id(case)
        exact, bounds, _ = T._oracle(a)
        same_inputs = bool(np.array_equal(got[f"{cid}/a_log"], a["a_log"]))
        for name, w, e, b in zip(T.NAMES, T._jax_vjp(a), exact, bounds):
            key = f"{cid}/{name}"
            if e is None:
                continue
            port = got[f"{key}/port"].astype(np.float64)
            w = np.asarray(w, np.float64)
            vs_jax = float(np.max(np.abs(port - w) / (2 * b)))
            vs_oracle = float(np.max(np.abs(port - e) / b))
            jax_vs_oracle = float(np.max(np.abs(w - e) / b))
            worst = max(worst, vs_jax, vs_oracle, jax_vs_oracle)
            print(json.dumps({
                "case": cid, "grad": name, "port_vs_jax_over_bound": vs_jax,
                "port_vs_oracle_over_bound": vs_oracle,
                "jax_vs_oracle_over_bound": jax_vs_oracle,
                "same_inputs": same_inputs,
                "same_oracle": bool(np.array_equal(got[f"{key}/oracle"], e)
                                    and np.array_equal(got[f"{key}/bound"], b)),
                "port_bits_as_here": bool(np.array_equal(
                    got[f"{key}/port"], T._plain_bwd(a)[T.NAMES.index(name)].numpy())),
            }))
    print(json.dumps({"worst_over_bound": worst, "ok": worst <= 1.0}))
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("dump", "compare"):
        sys.exit(__doc__)
    sys.exit(dump(sys.argv[2]) if sys.argv[1] == "dump" else compare(sys.argv[2]))
