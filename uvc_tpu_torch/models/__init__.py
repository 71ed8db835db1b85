"""Model registry dispatch (counterpart of ``uvc_tpu/models``).  The port
has the ViT/DeiT family, the T2T-ViT family and its architecture ablations
(SE, Ghost, Dense); CaiT and the R50 hybrid come with their slices."""

from uvc_tpu_torch.models import t2t_ablations, t2t_vit, vit


def get_model(cfg):
    if cfg.cls_attn_layers > 0 or cfg.hybrid:
        raise NotImplementedError(
            f"backbone {cfg.name} is not ported yet; see ROADMAP.md")
    if cfg.tokens_type != "none":
        if cfg.t2t_variant != "none":
            return t2t_ablations
        return t2t_vit
    return vit
