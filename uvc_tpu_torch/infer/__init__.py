from uvc_tpu_torch.infer.compact import apply_compact, compact_model  # noqa: F401
