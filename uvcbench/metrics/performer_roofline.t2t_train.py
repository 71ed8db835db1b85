"""The performer's share of its roofline: the performer wrappers'
launches in the traced stretch times each call's least time, over the
device time of the port's kernels launched inside a performer call (its
own kernels and its ``gemm_wg`` products, told apart by the host
operator that launched them), in %."""

from uvcbench.flops import Work


def read(record):
    if record["kind"] != "train" or "trace" not in record:
        return None
    tr, work = record["trace"], record["work"]
    calls = {k: tr["launches"].get(k, 0) for k in ("performer",
                                                    "performer_bwd")}
    if not any(calls.values()) or set(calls) - set(work):
        return None
    bound = sum(n * Work(*work[k]).bound_s() for k, n in calls.items())
    spent = sum(e["dur_s"] for e in tr["events"] if "uvc::" in e["name"]
                and any("performer" in op.lower() for op in e["stack"]))
    return 100.0 * bound / spent if spent > 0 else None
