"""The port's kernels' share of their roofline: the sum over the kernel
wrappers' launches in the traced stretch of each call's least time
(``flops.Work.bound_s`` at the cell's shapes), over the device time of
the kernels in the ``uvc::`` namespace, in %.  The T2T-ViT training
cells' reading, which moves ``t2t_train_img_s``."""

from uvcbench.flops import Work


def read(record):
    if record["kind"] != "train" or "trace" not in record:
        return None
    tr, work = record["trace"], record["work"]
    launched = {k: n for k, n in tr["launches"].items() if n}
    if not launched or set(launched) - set(work):
        return None
    bound = sum(n * Work(*work[k]).bound_s() for k, n in launched.items())
    spent = sum(e["dur_s"] for e in tr["events"] if "uvc::" in e["name"])
    return 100.0 * bound / spent if spent > 0 else None
