"""Configuration types of the LM zoo (counterpart of `repro.types`).

`ModelConfig` describes one LM-family architecture; the config files under
`repro_torch.configs` copy the JAX package's values verbatim, as
`ShapeConfig`, `SHAPES`, `MeshConfig` and `TrainConfig` copy theirs.
`HardwareSpec` has the reference's fields with the port's card in them,
`H100` (the dry run's roofline terms).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    Block pattern is derived from the family fields:
      * dense:   n_layers x (attn + mlp)
      * moe:     first_k_dense dense layers, then (attn + moe-mlp)
      * ssm:     n_layers x mamba2 block
      * hybrid:  mamba2 backbone with a *shared* attention block applied every
                 `hybrid_period` layers (zamba-style)
      * vlm:     self-attn layers with a cross-attn layer every
                 `cross_attn_period` layers (llama-3.2-vision style)
      * audio:   dense decoder over codec tokens (frontend stubbed)
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention flavour
    attn_type: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    # MLA (minicpm3 / deepseek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # hybrid (zamba2)
    hybrid_period: int = 0

    # vlm (llama-3.2-vision)
    cross_attn_period: int = 0
    n_ctx_tokens: int = 0  # stubbed modality frontend sequence length
    d_ctx: int = 0  # frontend embedding dim (0 -> d_model)

    # numerics
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention score chunking (flash-style): q-block length in the XLA path
    q_chunk: int = 1024
    # remat: none | full | dots (checkpoint_dots_with_no_batch_dims)
    remat: str = "full"
    # kernel or plain path of the ssm units' SSD and of GQA attention:
    # "kernel" (the hand-written CUDA kernels, `kernels/ssd` and
    # `kernels/flash_attention`) | "plain" (`models/ssm.py::ssd_scan` and
    # `models/attention.py::_grouped_attention`, the reference paths). The
    # JAX package names the same choice "pallas" | "xla" and defaults to
    # "xla"; the port defaults to the kernels.
    attn_impl: str = "kernel"
    # --- perf knobs (EXPERIMENTS.md §Perf; all default off = paper baseline) --
    # Megatron-style sequence parallelism: residual stream sharded over
    # 'model' on the SEQ dim between blocks (activation memory / tp_degree)
    seq_shard_activations: bool = False
    # context-parallel prefill: activations seq-sharded, K/V all-gathered
    # (collective bytes ~ O(kv) instead of O(activations))
    context_parallel: bool = False
    # chunked LM head + loss: never materialize [B, S, V] logits; compute the
    # softmax-CE scanning over seq chunks of this length (0 = off)
    loss_chunk: int = 0
    # causal chunk skip: unroll the q-chunk loop with per-chunk KV slices so
    # fully-masked blocks are never computed (~2x attention flops for long S;
    # the Pallas kernel always skips — this brings the XLA path to parity)
    causal_skip: bool = False
    # decode: pin K/V to the cache's seq-sharded layout inside attention
    # (forces flash-decoding-style partial softmax instead of KV all-gather /
    # full-stack resharding)
    decode_seq_shard_kv: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up for shardability (Megatron-style padding)."""
        if self.vocab_size < 2048:
            return self.vocab_size
        pad = 2048
        return ((self.vocab_size + pad - 1) // pad) * pad

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is supported (SSM or hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (analytic; used for MODEL_FLOPS and roofline) ------
    def param_count(self) -> tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = 0
        # embeddings (+ untied head)
        total += self.vocab_size * d
        if not self.tie_embeddings:
            total += d * self.vocab_size
        if self.family == "vlm":
            total += (self.d_ctx or d) * d  # frontend projection

        def attn_params() -> int:
            if self.attn_type == "mla":
                p = d * self.q_lora_rank
                p += self.q_lora_rank * nq * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * nq * (self.qk_nope_head_dim + self.v_head_dim)
                p += nq * self.v_head_dim * d
                return p
            return d * (nq + 2 * nkv) * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU

        def ssm_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            g = self.ssm_ngroups
            p = d * (2 * di + 2 * g * ns + nh)  # in_proj (z, x, B, C, dt)
            p += self.ssm_conv * (di + 2 * g * ns)  # depthwise conv
            p += nh * 2  # A_log, D
            p += di  # gated norm
            p += di * d  # out_proj
            return p

        total_layers = 0
        active_layers = 0
        if self.family in ("dense", "vlm", "audio"):
            n_cross = self.n_layers // self.cross_attn_period if self.cross_attn_period else 0
            n_self = self.n_layers - n_cross
            per_self = attn_params() + mlp_params(self.d_ff)
            # cross-attn layer: q from x, kv from ctx, + mlp
            per_cross = d * nq * hd + d * 2 * nkv * hd + nq * hd * d + mlp_params(self.d_ff)
            total_layers = n_self * per_self + n_cross * per_cross
            active_layers = total_layers
        elif self.family == "moe":
            dense_l = self.first_k_dense
            moe_l = self.n_layers - dense_l
            per_dense = attn_params() + mlp_params(self.d_ff)
            router = d * self.n_experts
            shared = mlp_params(self.moe_d_ff * self.n_shared_experts) if self.n_shared_experts else 0
            experts_total = self.n_experts * mlp_params(self.moe_d_ff)
            experts_active = self.top_k * mlp_params(self.moe_d_ff)
            per_moe_total = attn_params() + router + shared + experts_total
            per_moe_active = attn_params() + router + shared + experts_active
            total_layers = dense_l * per_dense + moe_l * per_moe_total
            active_layers = dense_l * per_dense + moe_l * per_moe_active
        elif self.family == "ssm":
            total_layers = self.n_layers * ssm_params()
            active_layers = total_layers
        elif self.family == "hybrid":
            n_shared_invocations = self.n_layers // self.hybrid_period if self.hybrid_period else 0
            n_mamba = self.n_layers - n_shared_invocations
            shared_block = attn_params() + mlp_params(self.d_ff)  # ONE copy
            total_layers = n_mamba * ssm_params() + shared_block
            active_layers = n_mamba * ssm_params() + n_shared_invocations * shared_block
        else:
            raise ValueError(self.family)

        # norms: negligible but count final norm
        total += total_layers + d
        active = self.vocab_size * d // max(1, 1) * 0  # embeddings: gather only
        active += active_layers + d
        if not self.tie_embeddings:
            active += d * self.vocab_size  # head matmul is active compute
        return total, active


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description (single pod: 16x16; multi-pod: 2x16x16)."""

    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class HardwareSpec:
    """One accelerator's peaks for the dry run's roofline terms (the
    reference's fields). These are DATASHEET peaks, not measurements: a card
    under a lower power limit, or a kernel below its peak, runs slower. The
    dry run reckons every collective at `ici_link_bandwidth`, the NVLink
    rate, which is a lower bound on the collective term of an axis whose
    ranks leave one 8-card NVLink node (InfiniBand between nodes is
    slower)."""

    name: str
    peak_flops_bf16: float  # FLOP/s per card, dense
    hbm_bandwidth: float  # B/s per card
    ici_link_bandwidth: float  # B/s per card and direction, the card-to-card link
    hbm_bytes: float  # per card


#: NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's H100 datasheet: dense
#: bf16 989 TFLOP/s (1,979 with sparsity), HBM3 3.35 TB/s, NVLink 4
#: 900 GB/s per card both directions together (450 GB/s each way), 80 GB.
H100 = HardwareSpec(name="h100-sxm5-80gb", peak_flops_bf16=989e12, hbm_bandwidth=3.35e12,
                    ici_link_bandwidth=450e9, hbm_bytes=80e9)


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"  # bfloat16 halves optimizer memory
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    max_step_retries: int = 2  # fault tolerance: retries before restore
