"""The frozen work counts against hand counts at small shapes and against
the program's own counts, and the model FLOP of a step from the
configuration."""
import pytest

from portbench.harness import work
from repro_torch.kernels import costs
from repro_torch.models.registry import get_config, get_smoke_config
from portbench.harness.program import config as program_config


def test_visible_pairs_by_hand():
    assert work.visible_pairs(4, 4, True, 0) == 1 + 2 + 3 + 4
    assert work.visible_pairs(4, 4, False, 0) == 16
    assert work.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert work.visible_pairs(2, 4, True, 0, q_offset=2) == 3 + 4


def test_flash_by_hand():
    # B 1, S 4, H 2, Dh 8, bf16, not causal: 16 pairs a head
    fwd = work.flash_forward((1, 4, 2, 8), (1, 4, 2, 8), 2, causal=False, window=0)
    assert fwd.flops == 4 * 8 * 16 * 2 and fwd.bytes == 2 * (2 * 64 + 2 * 64)
    lse = work.flash_forward((1, 4, 2, 8), (1, 4, 2, 8), 2, causal=False, window=0,
                             with_lse=True)
    assert lse.bytes - fwd.bytes == 4 * 2 * 4
    bwd = work.flash_backward((1, 4, 2, 8), (1, 4, 2, 8), 2, causal=False, window=0)
    assert bwd.flops == 10 * 8 * 16 * 2 and bwd.bytes == 2 * (4 * 64 + 4 * 64) + 4 * 2 * 4


def test_ssd_by_hand():
    # B 1, S 4, H 1, P 2, N 3, chunk 2: two chunks, 3 lower-triangle pairs each
    f = work.ssd_forward(1, 4, 1, 2, 3, 2, 2)
    per_chunk = 2 * 3 * 3 + (2 * 3 * 2 + 2 * 2 * 2 * 2 * 3)   # C·Bᵀ, intra, state + carried
    assert f.flops == 2 * per_chunk
    assert f.bytes == 2 * 8 * 2 + 4 * 4 + 4 + 2 * 12 * 2 + 6 * 4
    b = work.ssd_backward(1, 4, 1, 2, 3, 2, 2)
    assert b.flops == 2 * (4 * 3 * 3 + (8 * 2 * 2 * 3 + 4 * 3 * 2))


SHAPES = [(4, 2048, 64, 64, 128, 256), (2, 4103, 64, 64, 128, 256), (1, 5, 3, 2, 4, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_counts_are_the_programs(shape, h0):
    want = costs.ssd_forward(*shape, 2, h0=h0)
    assert tuple(work.ssd_forward(*shape, 2, h0=h0)) == (want.flops, want.bytes)
    assert (tuple(work.ssd_backward(*shape, 2, h0=h0, dh_final=h0))
            == tuple(costs.ssd_backward(*shape, 2, h0=h0, dh_final=h0))[:2])


@pytest.mark.parametrize("q, k, causal, window", [
    ((4, 2048, 16, 80), (4, 2048, 16, 80), False, 0),
    ((2, 4608, 32, 128), (2, 4608, 8, 128), True, 4096),
    ((1, 7, 2, 16), (1, 7, 1, 16), True, 3)])
def test_flash_counts_are_the_programs(q, k, causal, window):
    kw = dict(causal=causal, window=window)
    assert tuple(work.flash_forward(q, k, 2, with_lse=True, **kw)) == tuple(
        costs.flash_forward(q, k, 2, with_lse=True, **kw))[:2]
    want = costs.flash_backward(q, k, 2, **kw)
    assert tuple(work.flash_backward(q, k, 2, **kw)) == (want.flops, want.bytes)


def _model(cfg):
    import dataclasses
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hubert-xlarge"])
@pytest.mark.parametrize("smoke", [False, True])
def test_matmul_params_are_the_params_less_the_rest(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    model = _model(cfg)
    body, head = work.matmul_params(model)
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    if cfg.family == "ssm":  # tied: the output layer is the embedding
        conv = cfg.conv_width * (cfg.d_inner + 2 * cfg.ssm_state)
        assert head == V * D
        assert body + V * D + D + L * (conv + 2 * cfg.n_ssm_heads + cfg.d_inner + D) == (
            cfg.param_count())
    else:  # the port counts 2D of norms a layer and leaves the GELU MLP's biases aside
        assert body + head + V * D + D + 2 * D * L == cfg.param_count()


def test_full_size_step_flops():
    m2 = _model(get_config("mamba2-1.3b"))
    body, head = work.matmul_params(m2)
    assert round((body + head) / 1e6) == 1342
    ssd = 48 * (costs.ssd_forward(4, 2048, 64, 64, 128, 256, 2).flops
                + costs.ssd_backward(4, 2048, 64, 64, 128, 256, 2).flops)
    assert work.train_step_flops(m2, 4, 2048) == 6.0 * (body + head) * 8192 + ssd
    hb = _model(get_config("hubert-xlarge"))
    body, head = work.matmul_params(hb)
    attn = 48 * 4 * 80 * 2048 * 2048 * 4 * 16
    assert work.train_step_flops(hb, 4, 2048) == 6.0 * (body + head) * 8192 + 3 * attn
    assert round(3 * attn / 1e12, 1) == 12.4
    body, head = work.matmul_params(m2)
    assert work.prefill_flops(m2, 8, 1024) == (
        2.0 * body * 8192 + 2.0 * head * 8
        + 48 * costs.ssd_forward(8, 1024, 64, 64, 128, 256, 2).flops)


def test_bounds_take_the_larger_term():
    assert work.Work(989e12, 0).bound_s() == 1.0
    assert work.Work(0, 3.35e12).bound_s() == 1.0
    assert work.Work(989e9, 3.35e12).bound_s() == 1.0


def test_program_config_round_trip():
    cfg = get_config("hubert-xlarge")
    assert program_config(_model(cfg)) == cfg
