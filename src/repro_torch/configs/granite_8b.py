"""granite-8b [dense] 36L d4096 32H GQA-8 ff14336 v49152 (llama-arch, code)
[arXiv:2405.04324] — the assigned config and its reduced smoke config
(copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    arch_id='granite-8b',
    family='dense',
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10000.0,)

SMOKE_CONFIG = ModelConfig(
    arch_id='granite-8b',
    family='dense',
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
