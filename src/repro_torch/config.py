"""Configuration system: architecture, parallelism and run configs.

A copy of ``repro.config`` (the JAX package's own, framework-free), kept
here so that the PyTorch port imports nothing from the JAX package.

Every assigned architecture provides a ``src/repro_torch/configs/<id>.py``
with an ``ARCH`` constant built from these dataclasses; reduced smoke
variants are derived with :func:`reduced`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared_experts: int = 0
    d_shared: int = 0              # shared-expert FFN hidden size
    capacity_factor: float = 1.25
    router_softmax: bool = True    # softmax routing (vs sigmoid)
    #: int8-quantize the all-to-all dispatch payloads (per-slot scales) —
    #: the DeepSeek-V3 fp8-dispatch trick, halving EP wire bytes
    a2a_quant: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2/V3 Multi-head Latent Attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_seq: int = 1500        # whisper: 30s of audio at 50 Hz
    frontend: str = "stub"         # precomputed frame embeddings per spec


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    n_patches: int = 256           # precomputed patch embeddings per spec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    attn_bias: bool = False
    mlp_bias: bool = False
    mlp_act: str = "silu"          # silu | gelu
    mlp_gated: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    pos_embedding: str = "rope"    # rope | learned | none
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0        # leading dense layers before MoE stack
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0     # zamba2: shared attn block period
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    mtp_depth: int = 0             # DeepSeek-V3 multi-token prediction
    dtype: str = "bfloat16"
    # attention lowering: chunk sizes for the XLA flash path
    q_chunk: int = 1024
    kv_chunk: int = 1024
    #: pad query heads up to this count so they divide the TP axis (extra
    #: heads are zero-initialized AND output-masked -> bit-exact math and
    #: zero gradients; a recorded §Perf optimization, off by default)
    pad_heads_to: Optional[int] = None
    # sub-quadratic? (decides long_500k applicability)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += d * v  # output head
        hd = self.resolved_head_dim

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                      + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
                return p
            p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            p += self.n_heads * hd * d
            return p

        def mlp_params(ff: int) -> int:
            mats = 3 if self.mlp_gated else 2
            return mats * d * ff

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            conv_ch = d_in + 2 * s.n_groups * s.d_state
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += conv_ch * s.d_conv  # depthwise conv
            p += 2 * nh              # A_log, D
            p += nh                  # dt_bias
            p += d_in                # gated norm
            p += d_in * d            # out_proj
            return p

        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        elif self.family == "audio":
            enc = self.encdec.n_encoder_layers
            n += enc * (attn_params() + mlp_params(self.d_ff))
            # decoder: self-attn + cross-attn + mlp
            n += self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
        elif self.family == "moe":
            m = self.moe
            n += self.n_dense_layers * (attn_params() + mlp_params(self.d_ff))
            moe_layers = self.n_layers - self.n_dense_layers
            per = attn_params() + m.n_experts * mlp_params(m.d_expert)
            per += d * m.n_experts  # router
            if m.n_shared_experts:
                per += m.n_shared_experts * (3 if self.mlp_gated else 2) * d * m.d_shared
            n += moe_layers * per
        elif self.family == "ssm":
            n += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            n += self.n_layers * ssm_params()
            # one shared attention+MLP block (weights shared across uses)
            n += attn_params() + mlp_params(self.d_ff)
        if self.mtp_depth:
            n += self.mtp_depth * (attn_params() + (
                self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
                if self.moe else mlp_params(self.d_ff)))
        return int(n)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        moe_layers = self.n_layers - self.n_dense_layers + self.mtp_depth
        mats = 3 if self.mlp_gated else 2
        inactive = moe_layers * (m.n_experts - m.top_k) * mats * self.d_model * m.d_expert
        return int(total - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


#: the four assigned input shapes (identical for every LM arch)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "skipped(full-attention arch; long_500k needs sub-quadratic)"
    return True, ""


def reduced(arch: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw: dict = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, q_chunk=64, kv_chunk=64,
    )
    if arch.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_expert=32,
            n_shared_experts=arch.moe.n_shared_experts,
            d_shared=32 if arch.moe.n_shared_experts else 0)
        kw["n_dense_layers"] = min(arch.n_dense_layers, 1)
    if arch.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if arch.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=32)
        kw["n_kv_heads"] = 4
    if arch.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
        kw["n_layers"] = 4
    if arch.encdec is not None:
        kw["encdec"] = EncDecConfig(n_encoder_layers=2, encoder_seq=16)
    if arch.vision is not None:
        kw["vision"] = VisionStubConfig(n_patches=8)
    if arch.mtp_depth:
        kw["mtp_depth"] = 1
    kw.update(overrides)
    return dataclasses.replace(arch, **kw)
