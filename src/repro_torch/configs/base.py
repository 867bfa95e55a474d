"""Config registry helpers + systematic reduced (smoke-test) configs."""
from __future__ import annotations

from repro_torch.types import ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full architecture to a CPU-smoke-testable config of the SAME
    family/structure (GQA ratios, MoE routing, SSD chunking, hybrid/vlm
    periodicity are preserved; only widths/depths/tables shrink)."""
    kw: dict = dict(
        name=cfg.name + "-reduced",
        d_model=128,
        vocab_size=512,
        n_heads=4,
        d_head=32,
        param_dtype="float32",
        act_dtype="float32",
        q_chunk=64,
        remat="none",
    )
    fam = cfg.family
    if fam in ("dense", "audio"):
        kw.update(n_layers=2, d_ff=256, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4)
        if cfg.attn_type == "mla":
            kw.update(
                n_kv_heads=4,
                q_lora_rank=32,
                kv_lora_rank=16,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
    elif fam == "moe":
        kw.update(
            n_layers=3,
            d_ff=256,
            n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
            n_experts=8,
            top_k=min(cfg.top_k, 2),
            moe_d_ff=64,
            n_shared_experts=cfg.n_shared_experts,
            first_k_dense=1,
        )
    elif fam == "ssm":
        kw.update(
            n_layers=4, d_ff=0, n_kv_heads=4,
            ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1, ssm_chunk=32,
        )
    elif fam == "hybrid":
        kw.update(
            n_layers=7, d_ff=256, n_kv_heads=4, hybrid_period=3,
            ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1, ssm_chunk=32,
        )
    elif fam == "vlm":
        kw.update(
            n_layers=4, d_ff=256, n_kv_heads=2, cross_attn_period=2,
            n_ctx_tokens=16, d_ctx=32,
        )
    return cfg.replace(**kw)
