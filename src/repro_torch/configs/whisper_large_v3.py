"""whisper-large-v3 [audio] — enc-dec, conv frontend stub
[arXiv:2212.04356; unverified].

32 encoder + 32 decoder layers, d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866.  The mel/conv frontend is a stub: ``input_specs`` supplies
1500 precomputed frame embeddings to the encoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,               # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    mlp_variant="gelu",
    vocab_size=51866,
    enc_seq=1500,
    tie_embeddings=True,  # whisper ties decoder embed and output proj
)

REDUCED = ModelConfig(
    name="whisper-large-v3-reduced",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    enc_seq=24,
    attn_chunk=32,
)
