"""DeepSeek LLM 7B [arXiv:2401.02954]: llama-arch, 30L, d_model 4096,
32H MHA (kv=32), d_ff 11008, vocab 102400."""
from repro_torch.config import ArchConfig

ARCH = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, head_dim=128,
    rope_theta=10000.0, mlp_act="silu", mlp_gated=True,
)
