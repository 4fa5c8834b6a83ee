"""StarCoder2-7B [arXiv:2402.19173]: 32L, d_model 4608, 36H (GQA kv=4),
d_ff 18432, GQA + RoPE, gelu MLP with bias, LayerNorm."""
from repro_torch.config import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    rope_theta=1e5, attn_bias=True, mlp_bias=True,
    mlp_act="gelu", mlp_gated=False, norm="layernorm",
)
