"""Mamba-2 2.7B [arXiv:2405.21060]: 64L, d_model 2560, attention-free SSD,
d_state 128, headdim 64 (80 heads at expand=2), vocab 50280."""
from repro_torch.config import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    subquadratic=True, pos_embedding="none",
)
