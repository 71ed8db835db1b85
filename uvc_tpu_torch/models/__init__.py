"""Model registry dispatch (counterpart of ``uvc_tpu/models``): the
ViT/DeiT family with the R50 hybrid, the T2T-ViT family and its
architecture ablations (SE, Ghost, Dense), and CaiT.  Every module has
``init_params(generator, cfg, **kw)``, ``apply(params, x, cfg, **kw)``
and ``eval_logits(out, cfg)``, so the train steps are model-agnostic."""

from uvc_tpu_torch.models import cait, t2t_ablations, t2t_vit, vit


def get_model(cfg):
    if cfg.cls_attn_layers > 0:
        return cait
    if cfg.tokens_type != "none":
        if cfg.t2t_variant != "none":
            return t2t_ablations
        return t2t_vit
    return vit
