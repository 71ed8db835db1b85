"""Readings of the program's own spans (``uvc_tpu_torch/utils/profiler.py::
span``) in a run's traced stretch, for the per-layer metrics under
``metrics/``.  Each returns None where the stretch holds nothing to read:
in another kind of cell, in an untraced run, or on a program without the
spans."""

from uvcbench.flops import Work

ATTENTION = ("layer_attention_ln", "layer_attention_ln_bwd",
             "layer_attention", "layer_attention_bwd")
MLP = ("mlp_ln", "mlp_ln_blend", "mlp_ln_bwd", "mlp_ln_blend_bwd")


def _trace(record, kind):
    if record["kind"] != kind or "trace" not in record:
        return None
    return record["trace"]


def device_ms(record, span):
    """Device time a training step of the events launched inside
    ``span``, in ms."""
    tr = _trace(record, "train")
    if tr is None:
        return None
    spent = [e["dur_s"] for e in tr["events"] if span in e["stack"]]
    return 1e3 * sum(spent) / tr["units"] if spent else None


def host_ms(record, span):
    """The host's time a training step inside ``span``, in ms: its host
    time in the traced stretch (``span_totals``, which only a profiler
    session fills) over the stretch's steps."""
    tr = _trace(record, "train")
    if tr is None:
        return None
    try:
        from uvc_tpu_torch.utils.profiler import span_totals
    except ImportError:
        return None
    row = span_totals().get(span)
    return None if row is None else row["host_ms"] / tr["units"]


def sublayer_roofline(record, kind, wrappers):
    """The share of their roofline of the kernels of ``wrappers``: their
    launches in the traced stretch times each call's least time
    (``flops.Work.bound_s`` at the cell's shapes), over the device time of
    the ``uvc::`` kernels launched inside their ``uvc.op.<wrapper>``
    spans, in %.  None where a launched wrapper has no work given."""
    tr = _trace(record, kind)
    if tr is None:
        return None
    work = record["work"]
    launched = {k: n for k in wrappers if (n := tr["launches"].get(k, 0))}
    if not launched or set(launched) - set(work):
        return None
    bound = sum(n * Work(*work[k]).bound_s() for k, n in launched.items())
    spans = {f"uvc.op.{k}" for k in wrappers}
    spent = sum(e["dur_s"] for e in tr["events"] if "uvc::" in e["name"]
                and not spans.isdisjoint(e["stack"]))
    return 100.0 * bound / spent if spent > 0 else None
