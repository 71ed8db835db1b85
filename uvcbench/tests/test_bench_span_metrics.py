"""The readers of the program's spans on a hand-made record: the
optimizer's and the architecture update's device ms a step, the
optimizer's host ms a step, and the attention and MLP sublayers' roofline
shares; each None where its span is absent."""

import pytest

from uvcbench import run
from uvcbench.flops import Work

UNITS = 2
WORK = {"layer_attention_ln": (4e9, 1e6), "layer_attention_ln_bwd": (8e9, 2e6),
        "mlp_ln": (6e9, 1e6), "mlp_ln_blend_bwd": (1e10, 3e6)}
LAUNCHES = {"layer_attention_ln": 4, "layer_attention_ln_bwd": 2,
            "mlp_ln": 2, "mlp_ln_blend_bwd": 2}


def _ev(name, dur_s, *stack):
    return {"name": name, "start_s": 0.0, "dur_s": dur_s, "stack": stack}


def _record(kind="train", spans=True):
    def st(*names):
        return names if spans else ("uvcbench.step",)

    events = [
        _ev("void uvc::gemm_wg_kernel", 1e-3,
            *st("uvc.step", "uvc.forward", "uvc.op.layer_attention_ln")),
        _ev("uvc::layer_norm_kernel", 2e-3,
            *st("uvc.step", "uvc.teacher", "uvc.op.mlp_ln")),
        # the autograd engine's thread: the wrapper's span alone
        _ev("void uvc::core_bwd_q_wg_kernel", 3e-3,
            *st("uvc.op.layer_attention_ln_bwd")),
        _ev("uvc::gemm_act_bwd_kernel", 4e-3,
            *st("uvc.op.mlp_ln_blend_bwd")),
        _ev("void at::native::elementwise_kernel", 5e-4,
            *st("uvc.step", "uvc.optimizer")),
        _ev("void at::native::reduce_kernel", 7e-4,
            *st("uvc.step", "uvc.optimizer")),
        _ev("void at::native::elementwise_kernel", 3e-4,
            *st("uvc.step", "uvc.arch_update")),
        _ev("void at::native::elementwise_kernel", 9e-4, "aten::mul"),
    ]
    return {"kind": kind, "work": WORK,
            "trace": {"units": UNITS, "events": events,
                      "launches": dict(LAUNCHES)}}


def _bound(names):
    return sum(LAUNCHES[k] * Work(*WORK[k]).bound_s() for k in names)


@pytest.mark.parametrize("cell", ["train", "t2t_train"])
def test_phase_device_ms(cell):
    rec = _record()
    assert run.reader(f"optimizer_ms.{cell}")(rec) == pytest.approx(
        1e3 * 1.2e-3 / UNITS)
    assert run.reader(f"arch_update_ms.{cell}")(rec) == pytest.approx(
        1e3 * 3e-4 / UNITS)
    bare = _record(spans=False)
    assert run.reader(f"optimizer_ms.{cell}")(bare) is None
    assert run.reader(f"arch_update_ms.{cell}")(bare) is None
    assert run.reader(f"optimizer_ms.{cell}")(_record("serve")) is None


@pytest.mark.parametrize("cell", ["train", "t2t_train"])
def test_optimizer_host_ms(cell, monkeypatch):
    from uvc_tpu_torch.utils import profiler

    totals = {"uvc.optimizer": {"calls": UNITS, "host_ms": 9.0,
                                "self_host_ms": 9.0}}
    monkeypatch.setattr(profiler, "span_totals", lambda: totals)
    read = run.reader(f"optimizer_host_ms.{cell}")
    assert read(_record()) == pytest.approx(9.0 / UNITS)
    assert read(_record("serve")) is None
    monkeypatch.setattr(profiler, "span_totals", lambda: {})
    assert read(_record()) is None


@pytest.mark.parametrize("cell", ["train", "t2t_train", "serve"])
def test_sublayer_rooflines(cell):
    kind = "serve" if cell == "serve" else "train"
    rec = _record(kind)
    attn = run.reader(f"attention_roofline.{cell}")(rec)
    mlp = run.reader(f"mlp_roofline.{cell}")(rec)
    assert attn == pytest.approx(100.0 * _bound(
        ("layer_attention_ln", "layer_attention_ln_bwd")) / 4e-3)
    assert mlp == pytest.approx(100.0 * _bound(
        ("mlp_ln", "mlp_ln_blend_bwd")) / 6e-3)
    # the pooled share lies between the two where they cover the uvc::
    # kernels
    pooled = run.reader(f"kernels_roofline.{cell}")(rec)
    assert min(attn, mlp) <= pooled <= max(attn, mlp)
    # no span: nothing to divide by
    bare = _record(kind, spans=False)
    assert run.reader(f"attention_roofline.{cell}")(bare) is None
    assert run.reader(f"mlp_roofline.{cell}")(bare) is None
    # a launched wrapper whose work the cell does not give
    rec["work"] = {k: v for k, v in WORK.items() if k != "mlp_ln"}
    assert run.reader(f"mlp_roofline.{cell}")(rec) is None
    assert run.reader(f"attention_roofline.{cell}")(rec) == \
        pytest.approx(attn)
    other = "train" if kind == "serve" else "serve"
    assert run.reader(f"attention_roofline.{cell}")(_record(other)) is None
