"""The repo's own end-to-end example config: a ~100M-param dense LM sized
for the examples/train_lm.py driver (CPU-runnable training for a few
hundred steps)."""
from repro_torch.config import ArchConfig

ARCH = ArchConfig(
    name="exanest-lm-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab_size=32000, head_dim=64,
    rope_theta=10000.0, mlp_act="silu", mlp_gated=True,
    q_chunk=256, kv_chunk=256,
)
