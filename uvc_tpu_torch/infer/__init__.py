"""Serving: physical compaction (``infer.compact``) and the serving export
(``infer.export``).  ``apply_compact`` / ``compact_model`` are loaded on
first use, so that the export's load side imports no model code."""


def __getattr__(name):
    if name in ("apply_compact", "compact_model"):
        from uvc_tpu_torch.infer import compact
        return getattr(compact, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
