"""Model/architecture configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``.  Families:

- ``dense``  : llama-style decoder-only transformer, GQA attention.
- ``moe``    : mixture-of-experts FFN (capacity-based dispatch), optionally
               MLA attention + MTP head (deepseek-v3).
- ``ssm``    : attention-free Mamba2 (SSD) stack.
- ``hybrid`` : hymba-style parallel attention+mamba heads per layer.
- ``audio``  : whisper-style encoder-decoder (conv/mel frontend stubbed).
- ``vlm``    : decoder-only LM consuming projected vision-patch embeddings
               (ViT frontend stubbed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    num_shared: int = 0           # shared (always-on) experts
    top_k: int = 0
    d_ff_expert: int = 0          # hidden dim of each expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance auxiliary loss


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False        # qwen-style
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE / MLA / SSM sub-configs (None where not applicable)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp_depth: int = 0            # deepseek-v3 multi-token prediction depth
    # hybrid (hymba): fraction of inner dim given to mamba heads
    hybrid_attn_ratio: float = 0.5
    # sliding-window attention (None = full attention). Used natively by
    # hybrid archs; dense/moe archs use it only for the long_500k shape.
    sliding_window: Optional[int] = None
    # enc-dec (audio): encoder stack
    encoder_layers: int = 0
    encoder_seq: int = 0          # fixed frame count from the (stubbed) codec
    # vlm: number of vision-patch embeddings prefixed to the text sequence
    num_patches: int = 0
    # --- performance knobs (EXPERIMENTS.md §Perf; default = paper-faithful
    # baseline) ---
    pad_heads_to: int = 0      # pad q-heads so they shard on the model axis
                               # (zero-weight heads; function-preserving)
    cache_int8: bool = False   # int8 KV cache with per-(token,head) scales
    remat_mode: str = "full"   # "full" (checkpoint every layer) | "none"
    decode_cp: bool = False    # shard_map context-parallel flash-decode
    moe_group_size: int = 256  # MoE dispatch tokens per group (§Perf)
    moe_ragged: bool = False   # dropless ragged-dot dispatch (§Perf H4)
    # source citation for the config
    source: str = ""

    # ---- derived helpers -------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the logits dim shards cleanly (16-way model
        axis x 128 lanes). Ids >= vocab_size are never produced by the
        tokenizer; engines mask them at sampling."""
        m = 2048 if self.vocab_size >= 2048 else 16
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_mla(self) -> bool:
        return self.mla is not None

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Δ of Eq. (1)/(5): cache bytes appended per generated/prefilled
        token, per request (summed over layers)."""
        if self.family == "ssm":
            return 0  # constant state, no per-token growth (see state_bytes)
        if self.uses_mla:
            per_layer = self.mla.kv_lora_rank + self.mla.qk_rope_dim
        else:
            per_layer = 2 * self.num_kv_heads * self.head_dim
        n_attn_layers = self.num_layers
        if self.family == "hybrid":
            # attention sub-heads only; mamba heads contribute to state_bytes
            per_layer = int(per_layer)
        return per_layer * n_attn_layers * dtype_bytes

    def state_bytes(self, dtype_bytes: int = 2) -> int:
        """Constant per-request recurrent state (SSM / hybrid archs)."""
        if self.ssm is None:
            return 0
        d_in = self.ssm.d_inner(self.d_model)
        n_h = d_in // self.ssm.head_dim
        per_layer = n_h * self.ssm.head_dim * self.ssm.d_state + d_in * (
            self.ssm.conv_kernel - 1)
        return per_layer * self.num_layers * dtype_bytes

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        L, d, V = self.num_layers, self.d_model, self.vocab_size
        embed = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.d_inner(d)
            n_h = d_in // s.head_dim
            per_layer = d * (2 * d_in + 2 * s.d_state + n_h) \
                + d_in * s.conv_kernel + d_in * d
        else:
            if self.uses_mla:
                m = self.mla
                q_head = m.qk_nope_dim + m.qk_rope_dim
                attn = (d * m.q_lora_rank
                        + m.q_lora_rank * self.num_heads * q_head
                        + d * (m.kv_lora_rank + m.qk_rope_dim)
                        + m.kv_lora_rank * self.num_heads
                        * (m.qk_nope_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d)
            else:
                attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            if self.moe is not None:
                n_e = self.moe.num_experts + self.moe.num_shared
                ffn = n_e * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn
            if self.family == "hybrid":
                s = self.ssm
                d_in = s.d_inner(d) // 2  # half the inner dim to mamba heads
                n_h = max(1, d_in // s.head_dim)
                per_layer += d * (2 * d_in + 2 * s.d_state + n_h) \
                    + d_in * s.conv_kernel + d_in * d
        total = embed + L * per_layer
        if self.encoder_layers:
            enc_attn = d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim
            total += self.encoder_layers * (enc_attn + 3 * d * self.d_ff)
            # decoder cross-attention
            total += L * (d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_e = self.moe.num_experts + self.moe.num_shared
        all_expert = self.num_layers * n_e * 3 * self.d_model * self.moe.d_ff_expert
        act_expert = self.num_layers * (self.moe.top_k + self.moe.num_shared) \
            * 3 * self.d_model * self.moe.d_ff_expert
        return int(full - all_expert + act_expert)

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        scale = d_model / self.d_model
        head_dim = 64 if d_model >= 256 else 32
        n_heads = max(2, d_model // head_dim)
        if self.num_kv_heads == self.num_heads:
            n_kv = n_heads                      # keep MHA archs MHA
        else:
            ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
            n_kv = max(1, n_heads // ratio)
            while n_heads % n_kv:
                n_kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(max_experts, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                d_ff_expert=max(64, int(self.moe.d_ff_expert * scale)),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                            qk_rope_dim=16, v_head_dim=32)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=min(16, self.ssm.d_state),
                                      head_dim=32, chunk_size=32)
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=num_layers,
            d_model=d_model, num_heads=n_heads, num_kv_heads=n_kv,
            head_dim=head_dim, d_ff=max(64, int(self.d_ff * scale)),
            vocab_size=min(512, self.vocab_size), moe=moe, mla=mla, ssm=ssm,
            encoder_layers=min(2, self.encoder_layers),
            encoder_seq=min(16, self.encoder_seq),
            num_patches=min(8, self.num_patches),
            mtp_depth=min(1, self.mtp_depth),
            sliding_window=None if self.sliding_window is None
            else min(64, self.sliding_window),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
