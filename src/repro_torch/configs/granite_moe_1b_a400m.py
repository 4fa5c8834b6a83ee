"""IBM Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L, d_model 1024, 16H (GQA kv=8), 32 experts top-8, expert FFN 512."""
from repro_torch.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    n_dense_layers=0,
    rope_theta=10000.0, mlp_act="silu", mlp_gated=True,
)
