"""mamba2-780m [ssm] — SSD, attention-free [arXiv:2405.21060; unverified].

48L d_model=1536, d_state=128, headdim=64, expand=2 (d_inner=3072, 48 ssm
heads), vocab=50280.  Runs long_500k (O(1)-state decode).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,                 # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=8,                    # unused
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
)

REDUCED = ModelConfig(
    name="mamba2-780m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    head_dim=16,
    d_ff=8,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
)
