"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba-2 layers (d_state 64) with a
shared attention(+MLP) block applied every 6 layers; d_model 2560, 32H,
d_ff 10240, vocab 32000. Simplifications vs the HF release (documented in
DESIGN.md): no concat-with-embedding input to the shared block and no
per-invocation LoRA on the shared weights."""
from repro_torch.config import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    hybrid_attn_every=6, subquadratic=True,
    rope_theta=10000.0, mlp_act="gelu", mlp_gated=True,
)
