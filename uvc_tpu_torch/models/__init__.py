"""Model registry dispatch (counterpart of ``uvc_tpu/models``).  The port
has the ViT/DeiT family; the other backbones come with their slices."""

from uvc_tpu_torch.models import vit


def get_model(cfg):
    if cfg.cls_attn_layers > 0 or cfg.tokens_type != "none" or cfg.hybrid:
        raise NotImplementedError(
            f"backbone {cfg.name} is not ported yet; see ROADMAP.md")
    return vit
