"""The plain reference against the program's plain path (CPU, float32) at
the smoke configurations: the loss, every gradient, and the logits of
prefill and of decode through the cache; the weights' layout is the
program's; the frozen batch stream is the program's pipeline, byte for
byte; the float8 control rounds as float8 does."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import common, steps, synth
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.models import lm
from repro_torch.models.registry import get_smoke_config
from repro_torch.runtime.steps import loss_and_grads, make_decode_step, make_prefill_step
from repro_torch.tree import leaf_paths

CASES = [("mamba2-1.3b", "mamba2"), ("hubert-xlarge", "encoder")]


def _setup(arch, fam_name, dtype="float32"):
    cfg = get_smoke_config(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    model = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(cfg).items()}
    fam = steps.family(fam_name)
    return cfg, model, fam, fam.make_params(model, 2 ** 31 + 77, "cpu", getattr(torch, dtype))


@pytest.mark.parametrize("arch, fam", CASES)
def test_weights_have_the_programs_layout(arch, fam):
    cfg, _, _, params = _setup(arch, fam, "bfloat16")
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in leaf_paths(lm.init_params(cfg, torch.Generator(), "meta")).items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in common.leaves(params)} == want


@pytest.mark.parametrize("arch, fam", CASES)
def test_weights_repeat_for_a_seed_and_differ_between_seeds(arch, fam):
    _, model, f, a = _setup(arch, fam)
    b = f.make_params(model, 2 ** 31 + 77, "cpu", torch.float32)
    c = f.make_params(model, 2 ** 31 + 78, "cpu", torch.float32)
    la, lb, lc = (dict(common.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["embed/tok"], lc["embed/tok"])


@pytest.mark.parametrize("arch, fam", CASES)
@pytest.mark.parametrize("step", [0, 5])
def test_frozen_stream_is_the_pipelines(arch, fam, step):
    cfg, model, _, _ = _setup(arch, fam)
    want = synth_tokens(cfg, DataConfig(seq_len=24, global_batch=2, seed=2 ** 31 + 9), 0, 1, step)
    got = synth.batch(model, 24, 2, 2 ** 31 + 9, step)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])


@pytest.mark.parametrize("arch, fam", CASES)
def test_loss_and_gradients_match_the_program(arch, fam):
    cfg, model, f, params = _setup(arch, fam)
    host = synth.batch(model, 24, 2, 11, 0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    loss, _, grads = loss_and_grads(cfg, params, batch)
    named = {k: v.clone().requires_grad_(True) for k, v in common.leaves(params)}
    ref_loss = steps.train_loss(f, model, steps._unflatten(params, named), batch,
                                common.Precision())
    assert float(ref_loss.detach()) == pytest.approx(float(loss), rel=1e-6)
    ref_grads = torch.autograd.grad(ref_loss, list(named.values()), allow_unused=True)
    prog = leaf_paths(grads)
    for (k, p), g in zip(named.items(), ref_grads):
        g = torch.zeros_like(p) if g is None else g
        assert torch.allclose(g, prog[k], rtol=1e-4, atol=1e-6 * float(g.abs().max() + 1e-12)), k


def test_served_logits_match_prefill_and_decode():
    cfg, model, f, params = _setup("mamba2-1.3b", "mamba2")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(3))
    logits, cache = make_prefill_step(cfg, 24)(params, {"tokens": toks})
    decode = make_decode_step(cfg)
    tok, served, seen = logits.argmax(-1).to(torch.int32), [], [logits]
    for i in range(3):
        served.append(tok)
        tok, logits, cache = decode(params, cache, tok, torch.full((2,), 20 + i, dtype=torch.int32))
        seen.append(logits)
    served.append(tok)
    seq = torch.cat([toks, torch.stack(served[:-1], 1).long()], 1)
    at = torch.arange(19, 23)[None].expand(2, 4)
    ref = steps.logits_at(f, model, params, seq, at, common.Precision())
    assert torch.allclose(ref, torch.stack(seen, 1), atol=1e-5)
    assert float(steps.served_gaps(ref, torch.stack(served, 1)).max()) == 0.0


def test_float8_rounding():
    x = torch.tensor([448.0, -448.0, 1.0, 0.5])
    assert torch.equal(common.round_fp8(x), x)           # the scale is 1: all representable
    y = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    rel = ((common.round_fp8(y) - y).abs() / y.abs()).masked_select(y.abs() > y.abs().max() / 64)
    assert 0.01 < float(rel.max()) <= 2 ** -4
    p = common.Precision("fp8")
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(8, 3)
    out = p.mm(a, b)
    assert torch.allclose(out, common.round_fp8(a.detach()) @ common.round_fp8(b))
    out.sum().backward()      # straight through: the gradient of a plain product
    assert torch.allclose(a.grad, torch.ones(4, 3) @ common.round_fp8(b).t())
