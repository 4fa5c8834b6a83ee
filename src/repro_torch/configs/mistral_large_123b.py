"""Mistral-Large-Instruct-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407]:
88L, d_model 12288, 96H (GQA kv=8), d_ff 28672, vocab 32768."""
from repro_torch.config import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1e6, mlp_act="silu", mlp_gated=True,
)
