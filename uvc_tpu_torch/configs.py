"""Model configuration registry (counterpart of ``uvc_tpu/configs.py``).

A copy, not an import: the port imports nothing of the JAX package.  The
registry, field names and defaults are the JAX package's, and a test holds
the two registries equal field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture hyperparameters for a ViT/DeiT/T2T-ViT backbone."""

    name: str = "deit_tiny_patch16_224"
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    num_classes: int = 1000
    # Distillation token (DeiT-style two-token models).  The reference default
    # path runs enable_deit=0 (single cls token): joint_train.py:135-140, 832.
    distilled: bool = False
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    # T2T-ViT family: 'none' for conv patch embedding, else 'performer' or
    # 'transformer' tokens-to-token stem (UVC/T2TViT/models/t2t_vit.py:46-105).
    tokens_type: str = "none"
    token_dim: int = 64
    # T2T checkpoints use a fixed qk scale (t2t_vit.py:246: 384**-0.5).
    qk_scale: float | None = None
    # T2T uses fixed sinusoid position embeddings (t2t_vit.py:120).
    sinusoid_pos_embed: bool = False
    # R50+ViT hybrid: ResNetV2 stem feeds the patch embedding
    # (models/modeling.py:168-213, configs.py:55-66).
    hybrid: bool = False
    resnet_layers: Tuple[int, ...] = (3, 4, 9)
    resnet_width: int = 1
    # CaiT family (Baseline_pruning/cait_models.py): > 0 selects the CaiT
    # backbone with this many class-attention blocks.
    cls_attn_layers: int = 0
    layer_scale_init: float = 1e-5
    # T2T architecture ablations (T2TViT/models/t2t_vit_{se,ghost,dense}.py)
    t2t_variant: str = "none"       # none | se | ghost | dense
    growth_rate: int = 64
    dense_block_config: Tuple[int, ...] = (3, 6, 6, 4)

    @property
    def head_size(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def grid_size(self) -> int:
        if self.tokens_type != "none":
            # three soft-splits with strides 4,2,2 (t2t_vit.py:82)
            return self.img_size // 16
        if self.hybrid:
            # stem stride 16, then patch conv of size img//16//grid
            # (modeling.py:176-182): grid is fixed at 14 for 224px
            return self.img_size // 16
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_prefix_tokens

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


def _deit(name: str, embed_dim: int, depth: int, num_heads: int, **kw) -> ViTConfig:
    return ViTConfig(name=name, embed_dim=embed_dim, depth=depth,
                     num_heads=num_heads, mlp_ratio=4.0, qkv_bias=True, **kw)


# Registry keyed identically to the reference CLI --model_type choices
# (joint_train.py:694-697, modeling.py:435-452).
CONFIGS = {
    # DeiT family (models/configs.py:112-155 + deit variants used in scripts)
    "deit_tiny_patch16_224": _deit("deit_tiny_patch16_224", 192, 12, 3),
    "deit_small_patch16_224": _deit("deit_small_patch16_224", 384, 12, 6),
    "deit_base_patch16_224": _deit("deit_base_patch16_224", 768, 12, 12),
    "deit_tiny_distilled_patch16_224": _deit(
        "deit_tiny_distilled_patch16_224", 192, 12, 3, distilled=True),
    "deit_small_distilled_patch16_224": _deit(
        "deit_small_distilled_patch16_224", 384, 12, 6, distilled=True),
    "deit_base_distilled_patch16_224": _deit(
        "deit_base_distilled_patch16_224", 768, 12, 12, distilled=True),
    # Baseline-suite architecture variants (Baseline_pruning/models.py:
    # 94-126, 210-218: reduced-depth "half"/"8layer" baselines; :266-294:
    # 384px finetuning resolutions).  The *_sp / *_data registry entries
    # are the SAME architecture instrumented differently — covered here by
    # the shared backbone + the SP scorer / data-split loader.
    "deit_tiny_patch16_224_half": _deit(
        "deit_tiny_patch16_224_half", 192, 4, 3),
    "deit_tiny_patch16_224_8layer": _deit(
        "deit_tiny_patch16_224_8layer", 192, 8, 3),
    "deit_small_patch16_224_half": _deit(
        "deit_small_patch16_224_half", 384, 6, 6),
    "deit_base_patch16_224_half": _deit(
        "deit_base_patch16_224_half", 768, 6, 12),
    "deit_base_patch16_384": _deit(
        "deit_base_patch16_384", 768, 12, 12, img_size=384),
    "deit_base_distilled_patch16_384": _deit(
        "deit_base_distilled_patch16_384", 768, 12, 12, img_size=384,
        distilled=True),
    # jeonsworld ViT configs (models/configs.py:18-110)
    "ViT-B_16": ViTConfig(name="ViT-B_16", embed_dim=768, depth=12,
                          num_heads=12, qkv_bias=True),
    "ViT-B_32": ViTConfig(name="ViT-B_32", patch_size=32, embed_dim=768,
                          depth=12, num_heads=12),
    "ViT-L_16": ViTConfig(name="ViT-L_16", embed_dim=1024, depth=24,
                          num_heads=16),
    "ViT-L_32": ViTConfig(name="ViT-L_32", patch_size=32, embed_dim=1024,
                          depth=24, num_heads=16),
    "ViT-H_14": ViTConfig(name="ViT-H_14", patch_size=14, embed_dim=1280,
                          depth=32, num_heads=16),
    # R50 hybrid (models/configs.py:55-66, get_r50_b16_config)
    "R50-ViT-B_16": ViTConfig(name="R50-ViT-B_16", embed_dim=768, depth=12,
                              num_heads=12, hybrid=True,
                              resnet_layers=(3, 4, 9), resnet_width=1),
    # 'testing' micro config (models/configs.py:18-31) — the reference's only
    # fixture-like artifact; ours is MXU-aligned but still tiny.
    "testing": ViTConfig(name="testing", img_size=32, patch_size=16,
                         embed_dim=8, depth=1, num_heads=1, num_classes=10),
    # T2T-ViT family (UVC/T2TViT/models/t2t_vit.py:210-328)
    "t2t_vit_7": ViTConfig(name="t2t_vit_7", tokens_type="performer",
                           embed_dim=256, depth=7, num_heads=4, mlp_ratio=2.0,
                           qkv_bias=False, sinusoid_pos_embed=True),
    "t2t_vit_10": ViTConfig(name="t2t_vit_10", tokens_type="performer",
                            embed_dim=256, depth=10, num_heads=4,
                            mlp_ratio=2.0, qkv_bias=False,
                            sinusoid_pos_embed=True),
    "t2t_vit_12": ViTConfig(name="t2t_vit_12", tokens_type="performer",
                            embed_dim=256, depth=12, num_heads=4,
                            mlp_ratio=2.0, qkv_bias=False,
                            sinusoid_pos_embed=True),
    "t2t_vit_14": ViTConfig(name="t2t_vit_14", tokens_type="performer",
                            embed_dim=384, depth=14, num_heads=6,
                            mlp_ratio=3.0, qkv_bias=False,
                            qk_scale=384 ** -0.5, sinusoid_pos_embed=True),
    "t2t_vit_19": ViTConfig(name="t2t_vit_19", tokens_type="performer",
                            embed_dim=448, depth=19, num_heads=7,
                            mlp_ratio=3.0, qkv_bias=False,
                            sinusoid_pos_embed=True),
    "t2t_vit_24": ViTConfig(name="t2t_vit_24", tokens_type="performer",
                            embed_dim=512, depth=24, num_heads=8,
                            mlp_ratio=3.0, qkv_bias=False,
                            sinusoid_pos_embed=True),
    "t2t_vit_t_14": ViTConfig(name="t2t_vit_t_14", tokens_type="transformer",
                              embed_dim=384, depth=14, num_heads=6,
                              mlp_ratio=3.0, qkv_bias=False,
                              sinusoid_pos_embed=True),
    "t2t_vit_t_19": ViTConfig(name="t2t_vit_t_19", tokens_type="transformer",
                              embed_dim=448, depth=19, num_heads=7,
                              mlp_ratio=3.0, qkv_bias=False,
                              sinusoid_pos_embed=True),
    "t2t_vit_t_24": ViTConfig(name="t2t_vit_t_24", tokens_type="transformer",
                              embed_dim=512, depth=24, num_heads=8,
                              mlp_ratio=3.0, qkv_bias=False,
                              sinusoid_pos_embed=True),
    # resnext/wide structure ablations (t2t_vit.py:308-328)
    "t2t_vit_14_resnext": ViTConfig(
        name="t2t_vit_14_resnext", tokens_type="performer", embed_dim=384,
        depth=14, num_heads=32, mlp_ratio=3.0, qkv_bias=False,
        sinusoid_pos_embed=True),
    "t2t_vit_14_wide": ViTConfig(
        name="t2t_vit_14_wide", tokens_type="performer", embed_dim=768,
        depth=4, num_heads=12, mlp_ratio=3.0, qkv_bias=False,
        sinusoid_pos_embed=True),
    # T2T architecture ablations (t2t_vit_se.py:160, t2t_vit_ghost.py:188,
    # t2t_vit_dense.py:163)
    "t2t_vit_14_se": ViTConfig(
        name="t2t_vit_14_se", tokens_type="performer", t2t_variant="se",
        embed_dim=384, depth=14, num_heads=6, mlp_ratio=3.0,
        qkv_bias=False, sinusoid_pos_embed=True),
    "t2t_vit_16_ghost": ViTConfig(
        name="t2t_vit_16_ghost", tokens_type="performer",
        t2t_variant="ghost", embed_dim=384, depth=16, num_heads=6,
        mlp_ratio=3.0, qkv_bias=False, sinusoid_pos_embed=True),
    "t2t_vit_dense": ViTConfig(
        name="t2t_vit_dense", tokens_type="performer", t2t_variant="dense",
        embed_dim=128, num_heads=8, mlp_ratio=2.0, growth_rate=64,
        dense_block_config=(3, 6, 6, 4), qkv_bias=False,
        sinusoid_pos_embed=True),
    # CaiT baselines (Baseline_pruning/cait_models.py:256-400)
    "cait_XS24": ViTConfig(name="cait_XS24", img_size=384, embed_dim=288,
                           depth=24, num_heads=6, cls_attn_layers=2),
    "cait_S24_224": ViTConfig(name="cait_S24_224", embed_dim=384, depth=24,
                              num_heads=8, cls_attn_layers=2),
    "cait_S24": ViTConfig(name="cait_S24", img_size=384, embed_dim=384,
                          depth=24, num_heads=8, cls_attn_layers=2),
    "cait_S36": ViTConfig(name="cait_S36", img_size=384, embed_dim=384,
                          depth=36, num_heads=8, cls_attn_layers=2,
                          layer_scale_init=1e-6),
}

deit_family = [k for k in CONFIGS if k.startswith("deit")]


def get_config(name: str) -> ViTConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"Unknown model_type {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]
