"""The five assigned LM-family architectures (exact published configs).

A copy of ``repro/configs/lm_archs.py``, field for field, on the port's
``TransformerConfig`` (float32 by default, as the reference's).
"""
from __future__ import annotations

from repro_torch.configs.base import LMArch
from repro_torch.models.layers import MoeConfig
from repro_torch.models.transformer import TransformerConfig


def _gemma2_27b() -> TransformerConfig:
    # [arXiv:2408.00118]: 46L, d=4608, 32H (GQA kv=16), d_ff=36864,
    # vocab=256000; alternating 4096-window local / global attention;
    # attn softcap 50, final softcap 30; GeGLU; tied + scaled embeddings;
    # query scale = 1/sqrt(d_model/n_heads) = 1/sqrt(144).
    return TransformerConfig(
        name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32, n_kv=16,
        d_ff=36864, vocab=256000, head_dim=128, block_style="sandwich",
        act="gelu", attn_softcap=50.0, final_softcap=30.0,
        query_scale=(4608 / 32) ** -0.5, tie_embeddings=True,
        scale_embeddings=True, window_pattern=(4096, None),
        rope_theta=10000.0, remat="full")


def _gemma2_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, head_dim=16, block_style="sandwich", act="gelu",
        attn_softcap=50.0, final_softcap=30.0, query_scale=16 ** -0.5,
        tie_embeddings=True, scale_embeddings=True, window_pattern=(16, None))


def _command_r_plus() -> TransformerConfig:
    # [hf:CohereForAI/c4ai-command-r-plus]: 64L, d=12288, 96H (GQA kv=8),
    # d_ff=33792, vocab=256000; parallel attention+FFN blocks, no bias,
    # tied embeddings, rope 75e4... (use 10k default; unverified tier).
    return TransformerConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv=8, d_ff=33792, vocab=256000, head_dim=128,
        block_style="parallel", act="silu", tie_embeddings=True,
        rope_theta=75000.0, remat="full")


def _command_r_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-smoke", n_layers=3, d_model=64, n_heads=8, n_kv=2,
        d_ff=128, vocab=512, head_dim=8, block_style="parallel",
        tie_embeddings=True)


def _granite_34b() -> TransformerConfig:
    # [arXiv:2405.04324] Granite code 34B: 88L, d=6144, 48H (MQA kv=1),
    # d_ff=24576, vocab=49152. GPT-BigCode lineage: MQA + plain (non-gated)
    # 2-matrix MLP — matches the 34B total; the assignment's "llama-arch"
    # note covers the pre-norm decoder block structure.
    return TransformerConfig(
        name="granite-34b", n_layers=88, d_model=6144, n_heads=48, n_kv=1,
        d_ff=24576, vocab=49152, head_dim=128, block_style="prenorm",
        mlp_style="plain", act="gelu", tie_embeddings=True, remat="full")


def _granite_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="granite-smoke", n_layers=3, d_model=48, n_heads=6, n_kv=1,
        d_ff=96, vocab=512, head_dim=8, block_style="prenorm",
        mlp_style="plain", act="gelu")


def _moonshot_16b() -> TransformerConfig:
    # [hf:moonshotai/Moonlight-16B-A3B]: 48L... spec sheet (assignment):
    # 48L (but 27L in HF — we follow the assignment row): d=2048, 16H
    # (kv=16), MoE 64 experts top-6, expert d_ff=1408, vocab=163840,
    # 2 shared experts of d_ff=2816 (moonlight uses shared experts).
    return TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv=16, d_ff=1408, vocab=163840, head_dim=128,
        block_style="prenorm", act="silu", tie_embeddings=True,
        moe=MoeConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      d_ff_shared=2816), remat="full")


def _moonshot_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        d_ff=64, vocab=512, head_dim=16,
        moe=MoeConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1,
                      d_ff_shared=96))


def _qwen3_moe() -> TransformerConfig:
    # [hf:Qwen/Qwen3-235B-A22B]: 94L, d=4096, 64H (GQA kv=4), MoE 128
    # experts top-8, expert d_ff=1536, vocab=151936.
    return TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv=4, d_ff=1536, vocab=151936, head_dim=128, block_style="prenorm",
        act="silu", tie_embeddings=True,
        moe=MoeConfig(n_experts=128, top_k=8, d_ff=1536), remat="full")


def _qwen3_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-smoke", n_layers=3, d_model=64, n_heads=8, n_kv=2,
        d_ff=96, vocab=512, head_dim=8,
        moe=MoeConfig(n_experts=8, top_k=2, d_ff=48))


GEMMA2_27B = LMArch("gemma2-27b", _gemma2_27b, _gemma2_smoke)
COMMAND_R_PLUS = LMArch("command-r-plus-104b", _command_r_plus,
                        _command_r_smoke)
GRANITE_34B = LMArch("granite-34b", _granite_34b, _granite_smoke)
MOONSHOT_16B = LMArch("moonshot-v1-16b-a3b", _moonshot_16b, _moonshot_smoke)
QWEN3_MOE = LMArch("qwen3-moe-235b-a22b", _qwen3_moe, _qwen3_smoke)
