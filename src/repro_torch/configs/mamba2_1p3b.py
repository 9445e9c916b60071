"""mamba2-1.3b [ssm] 48L d2048 attn-free v50280, ssm_state=128, SSD — the
assigned config and its reduced smoke config (copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    remat_policy='save_dots',
    arch_id='mamba2-1.3b',
    family='ssm',
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    head_dim=1,
    tie_embeddings=True,)

SMOKE_CONFIG = ModelConfig(
    arch_id='mamba2-1.3b',
    family='ssm',
    n_layers=4,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=8,
    conv_width=4,
    head_dim=1,
    tie_embeddings=True,)
