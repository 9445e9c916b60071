"""hubert-xlarge [audio] 48L d1280 16H MHA ff5120 v504 (encoder-only, w2v2
family) [arXiv:2106.07447] — the assigned config and its reduced smoke config
(copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    remat_policy='save_dots',
    arch_id='hubert-xlarge',
    family='encoder',
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act='gelu',
    norm='layernorm',
    frontend='audio_frames',
    rope_theta=10000.0,)

SMOKE_CONFIG = ModelConfig(
    arch_id='hubert-xlarge',
    family='encoder',
    causal=False,
    act='gelu',
    norm='layernorm',
    frontend='audio_frames',
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,)
