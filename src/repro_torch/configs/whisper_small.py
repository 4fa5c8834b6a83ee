"""Whisper-small [arXiv:2212.04356]: enc-dec, 12+12L, d_model 768, 12H,
d_ff 3072, vocab 51865; conv frontend is a STUB (precomputed frame
embeddings, 1500 frames)."""
from repro_torch.config import ArchConfig, EncDecConfig

ARCH = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    mlp_act="gelu", mlp_gated=False, norm="layernorm",
    pos_embedding="learned", attn_bias=True,
    encdec=EncDecConfig(n_encoder_layers=12, encoder_seq=1500),
)
