"""The idle arithmetic: busy time is the union of the device intervals,
and a gap is named by the host operator that launched the event after
it."""

from uvcbench import trace


def test_union_merges_overlaps():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (3, 4)]) == \
        [(0, 4), (5, 6)]


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_reduce_busy_idle_and_gap_names():
    events = [
        _ev("user_annotation", "uvcbench.step", 0, 100),
        _ev("cpu_op", "aten::mm", 10, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        _ev("cpu_op", "uvc_tpu_torch::performer", 40, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=3),
        # two overlapping kernels, then a gap of 20 us, then a copy
        _ev("kernel", "void uvc::gemm", 20, 10, corr=1, tid=7),
        _ev("kernel", "void uvc::performer::k", 25, 10, corr=2, tid=8),
        _ev("gpu_memcpy", "Memcpy HtoD", 55, 5, corr=3, tid=7),
        _ev("gpu_user_annotation", "uvcbench.step", 0, 100, tid=7),
    ]
    out = trace.reduce(events)
    assert len(out["events"]) == 3
    assert abs(out["wall_s"] - 40e-6) < 1e-12
    assert abs(out["busy_s"] - 20e-6) < 1e-12
    assert len(out["gaps"]) == 1
    name, secs = out["gaps"][0]
    assert abs(secs - 20e-6) < 1e-12
    assert name == "uvcbench.step > uvc_tpu_torch::performer"
    stacks = [e["stack"] for e in out["events"]]
    assert stacks[1] == ("uvcbench.step", "uvc_tpu_torch::performer")
    b = trace.breakdown(out)
    assert b["device_ops"][0][1] > 0 and len(b["idle_gaps"]) == 1
