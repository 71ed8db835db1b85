"""The port's CLIs (uvc_tpu_torch/cli/{flags,joint_train,post_train,
export_compact}.py), logging and profiler against the JAX package's, on
the CPU (``--device cpu``).

The parsers must take every flag of the JAX package's with the same
default; the tiny two-stage runs of ``tests/test_e2e.py`` run through the
port's CLIs; each package's ``post_train`` reads the other's stage-1
checkpoint; the compact export serves through ``apply_compact`` with the
masked-dense eval forward's logits; the routes that are not ported raise
``NotImplementedError`` naming their ROADMAP item, and the mesh flags
JAX's errors; and importing the new modules (the R50 stem, CaiT and the
data-parallel modules among them) loads neither JAX nor msgpack.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import uvc_tpu.configs as jconfigs
from uvc_tpu.cli import export_compact as j_export
from uvc_tpu.cli import joint_train as j_joint
from uvc_tpu.cli import post_train as j_post
from uvc_tpu.compress.minimax import init_compression_state
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu.utils import logging as jlogging
from uvc_tpu.utils.checkpoint import load_checkpoint as j_load
from uvc_tpu.utils.checkpoint import save_checkpoint as j_save
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.cli import export_compact as t_export
from uvc_tpu_torch.cli import flags as tflags
from uvc_tpu_torch.cli import joint_train as t_joint
from uvc_tpu_torch.cli import post_train as t_post
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.infer.compact import apply_compact
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.utils import logging as tlogging
from uvc_tpu_torch.utils import profiler as tprofiler
from uvc_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]

# tests/test_e2e.py's tiny runs
TINY = ["--model_type", "testing", "--dataset", "synthetic",
        "--img_size", "32", "--train_batch_size", "8",
        "--eval_batch_size", "8"]


class _Parsed(Exception):
    """Raised in place of parsing, carrying the parser."""


@pytest.fixture
def grab_parser(monkeypatch):
    """Run a CLI's ``main`` until it parses its arguments; return the
    parser it built."""
    def grab(main, argv):
        def fake(self, args=None, namespace=None):
            if self.add_help:                 # not the --config pre-parser
                raise _Parsed(self)
            return real(self, args, namespace)
        real = argparse.ArgumentParser.parse_known_args
        monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args",
                            fake)
        with pytest.raises(_Parsed) as e:
            main(argv)
        monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args",
                            real)
        return e.value.args[0]
    return grab


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", ["joint_train", "post_train",
                                 "export_compact"])
def test_parsers_take_every_jax_flag(grab_parser, cli):
    """Every flag of the JAX parser, with its option strings, default,
    type, choices, nargs and action; the port adds ``--device`` only."""
    mains = {"joint_train": (j_joint.main, t_joint.main),
             "post_train": (j_post.main, t_post.main),
             "export_compact": (j_export.main, t_export.main)}[cli]
    jp, tp = (_actions(grab_parser(m, [])) for m in mains)
    assert set(tp) - set(jp) == {"device"}
    for dest, ja in jp.items():
        ta = tp[dest]
        for attr in ("option_strings", "default", "type", "choices",
                     "nargs", "const", "required"):
            assert getattr(ta, attr) == getattr(ja, attr), (dest, attr)
        assert type(ta) is type(ja), dest
    assert tp["device"].default == "cuda"


@pytest.mark.parametrize("cli", ["joint_train", "post_train"])
def test_parsed_values_match(cli):
    """Parsing one command line gives the same values and hyperparameters
    (the --config YAML route included)."""
    argv = TINY + ["--num_epochs", "3", "--budget", "0.4", "--mixup", "0.2",
                   "--cutmix-minmax", "0.2", "0.8", "--opt-betas", "0.8",
                   "0.9", "--zlr_schedule_list", "1,2", "--sched", "cosine"]
    if cli == "joint_train":
        argv = [a for a in argv if a not in ("--opt-betas", "0.8", "0.9",
                                             "--sched", "cosine")]

    def parse(flags_mod):
        p = argparse.ArgumentParser()
        flags_mod.add_common_flags(p)
        flags_mod.add_uvc_flags(p)
        if cli == "post_train":
            flags_mod.add_stage2_flags(p)
        return flags_mod.parse_with_config(p, argv)

    from uvc_tpu.cli import flags as jflags
    ja, ta = parse(jflags), parse(tflags)
    tv = vars(ta)
    assert tv.pop("device") == "cuda"
    assert tv == vars(ja)
    assert vars(tflags.to_hparams(ta)) == vars(jflags.to_hparams(ja))
    jt = vars(jflags.to_train_hparams(ja, 7, 10, stage2=True))
    tt = vars(tflags.to_train_hparams(ta, 7, 10, stage2=True))
    assert jt.pop("compute_dtype") == jnp.bfloat16
    assert tt.pop("compute_dtype") == torch.bfloat16
    assert tt == jt
    for ds in ("cifar10", "cifar100", "procedural", "imagenet", "synthetic"):
        assert tflags.num_classes_for(ds) == jflags.num_classes_for(ds)


def test_config_file_overrides_defaults(tmp_path):
    pytest.importorskip("yaml")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("budget: 0.3\nnum_epochs: 7\n")
    p = argparse.ArgumentParser()
    tflags.add_common_flags(p)
    tflags.add_uvc_flags(p)
    args = tflags.parse_with_config(p, ["-c", str(cfg), "--num_epochs", "9"])
    assert args.budget == 0.3 and args.num_epochs == 9
    cfg.write_text("no_such_flag: 1\n")
    with pytest.raises(SystemExit):
        tflags.parse_with_config(p, ["-c", str(cfg)])


def test_cli_joint_train_tiny(tmp_path):
    """tests/test_e2e.py::test_cli_joint_train_tiny through the port."""
    t_joint.main(TINY + [
        "--synthetic_steps", "3", "--num_epochs", "2",
        "--warmup_epochs", "1", "--post_num_epochs", "1",
        "--warmup_steps", "2", "--zlr_schedule_list", "1,5",
        "--gating_interval", "2", "--enable_patch_gating", "0",
        "--distillation-type", "soft", "--eval_every", "3", "--dp", "1",
        "--device", "cpu", "--output_dir", str(tmp_path), "--name", "smoke"])
    out = tmp_path / "smoke"
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    keys = set().union(*recs)
    assert {"train/flops_expectation", "train/flops_real",
            "train/flops_real_argmax", "train/param_size",
            "test/accuracy"} <= keys
    assert sorted(p.name for p in out.glob("*.ckpt")) == [
        "testing_1.ckpt", "testing_2.ckpt", "testing_post_0.ckpt"]


def _port_stage1_ckpt(tmp_path, patch_gating="0"):
    t_joint.main(TINY + [
        "--synthetic_steps", "2", "--num_epochs", "1", "--warmup_epochs",
        "1", "--post_num_epochs", "0", "--warmup_steps", "1",
        "--enable_patch_gating", patch_gating, "--dp", "1",
        "--device", "cpu", "--output_dir", str(tmp_path), "--name", "s1"])
    return sorted((tmp_path / "s1").glob("*.ckpt"))[0]


def test_stage2_cli_from_ckpt(tmp_path):
    """tests/test_e2e.py::test_stage2_cli_from_ckpt through the port, with
    --compact_train too."""
    ckpt = _port_stage1_ckpt(tmp_path)
    for name, extra in (("s2", []), ("s2c", ["--compact_train"])):
        t_post.main(TINY + [
            "--synthetic_steps", "2", "--num_epochs", "1",
            "--enable_patch_gating", "0", "--checkpoint_dir", str(ckpt),
            "--eval_every", "2", "--dp", "1", "--device", "cpu",
            "--output_dir", str(tmp_path), "--name", name] + extra)
        assert (tmp_path / name / "metrics.jsonl").exists()
        ck = load_checkpoint(str(tmp_path / name / "testing_post_0.ckpt"))
        assert bool(ck["compact"]) == bool(extra)


def test_jax_post_train_reads_the_port_checkpoint(tmp_path):
    ckpt = _port_stage1_ckpt(tmp_path)
    j_post.main(TINY + [
        "--synthetic_steps", "2", "--num_epochs", "1",
        "--enable_patch_gating", "0", "--checkpoint_dir", str(ckpt),
        "--dp", "1", "--output_dir", str(tmp_path), "--name", "j2"])
    ck = j_load(str(tmp_path / "j2" / "testing_post_0.ckpt"))
    assert int(ck["global_step"]) == 2
    ref = load_checkpoint(str(ckpt))
    np.testing.assert_array_equal(np.asarray(ck["masks"]["attn"]),
                                  ref["masks"]["attn"].numpy())


def _jax_stage1_ckpt(path, with_masks=True):
    """A stage-1 checkpoint as the JAX driver writes it (the testing
    model, s / r pruning a head of layer 0 and half the MLP units)."""
    cfg = jconfigs.get_config("testing").replace(num_classes=1000)
    params = jvit.init_params(jax.random.PRNGKey(3), cfg)
    hp = JHParams(enable_patch_gating=0)
    st = jstate.create_train_state(params, jstate.TrainHParams(),
                                   init_compression_state(cfg, hp))
    cstate = st.cstate.replace(s=jnp.array([[0.0, 16.0]]),
                               r=jnp.array([[2.0]]))
    from uvc_tpu.compress.masks import build_masks
    masks = build_masks(params, cstate.s, cstate.r, cfg)
    tree = {"params": params, "cstate": serialization.to_state_dict(cstate),
            "opt_state": serialization.to_state_dict(st.opt_state),
            "epoch": 1, "step": 2, "global_step": 2, "key_seed": 43}
    if with_masks:
        tree["masks"] = masks
    j_save(str(path), tree)
    return masks


@pytest.mark.parametrize("with_masks", [True, False],
                         ids=["masks", "masks_from_cstate"])
def test_port_post_train_reads_the_jax_checkpoint(tmp_path, with_masks):
    ckpt = tmp_path / "testing_1.ckpt"
    masks = _jax_stage1_ckpt(ckpt, with_masks)
    tcfg = tconfigs.get_config("testing").replace(num_classes=1000)
    params, tmasks = t_post.stage1_params_and_masks(str(ckpt), tcfg)
    for k in ("attn", "mlp"):
        np.testing.assert_array_equal(tmasks[k].numpy(),
                                      np.asarray(masks[k]))
    assert float(tmasks["mlp"].sum()) == tcfg.mlp_hidden - 16
    t_post.main(TINY + [
        "--synthetic_steps", "2", "--num_epochs", "1",
        "--enable_patch_gating", "0", "--checkpoint_dir", str(ckpt),
        "--dp", "1", "--device", "cpu", "--output_dir", str(tmp_path),
        "--name", "t2"])
    ck = load_checkpoint(str(tmp_path / "t2" / "testing_post_0.ckpt"))
    assert int(ck["global_step"]) == 2
    np.testing.assert_array_equal(ck["masks"]["mlp"].numpy(),
                                  np.asarray(masks["mlp"]))


def _serve_export(path, device="cpu"):
    """The compact layers and top of an export file, ready for
    ``apply_compact``."""
    ck = load_checkpoint(str(path))
    layers = [ck["layers"][str(i)] for i in range(len(ck["layers"]))]
    for blk in layers:
        blk["num_heads"] = int(blk["num_heads"])
    return layers, ck["top"], ck


@pytest.mark.parametrize("token_ratio", [None, 0.7])
def test_export_compact_serves_the_masked_dense_logits(tmp_path,
                                                       token_ratio):
    """The port's export of a JAX stage-1 checkpoint, read back with the
    codec, holds ``compact_model``'s layers bit for bit, and serves through
    ``apply_compact`` (bf16, as exported) the masked-dense eval forward's
    logits within 2e-2 relative Frobenius (the bf16 model tolerance of
    chip_smoke.py)."""
    from uvc_tpu_torch.infer.compact import compact_model
    from uvc_tpu_torch.utils.tree import tree_leaves_with_path
    ckpt = tmp_path / "s1.ckpt"
    _jax_stage1_ckpt(ckpt)
    out = tmp_path / "compact.ckpt"
    argv = ["--model_type", "testing", "--checkpoint", str(ckpt),
            "--save_file", str(out), "--img_size", "32", "--device", "cpu"]
    if token_ratio:
        argv += ["--token_ratio", str(token_ratio)]
    t_export.main(argv)
    layers, top, ck = _serve_export(out)
    assert ck["model_type"] == "testing" and int(ck["img_size"]) == 32
    assert float(ck["token_ratio"]) == (token_ratio or -1.0)
    # the testing model's 16 kept units pad to its full 32: no saving
    assert 0.0 < float(ck["flops_fraction"]) <= 1.0
    cfg = tconfigs.get_config("testing").replace(num_classes=1000)
    params, masks = t_post.stage1_params_and_masks(str(ckpt), cfg)
    ref_layers, ref_top = compact_model(params, masks, cfg, device="cpu")
    for mine, ref in ((layers, ref_layers), (top, ref_top)):
        # the file holds every dict's keys sorted
        got = sorted(tree_leaves_with_path(mine), key=lambda kv: kv[0])
        want = sorted(tree_leaves_with_path(ref), key=lambda kv: kv[0])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), p
    # the zero-initialised head gives all-zero logits: serve through a
    # random head instead
    head = torch.randn(cfg.embed_dim, 1000,
                       generator=torch.Generator().manual_seed(0))
    params["head"]["kernel"] = head
    top["head"]["kernel"] = head
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    keep = (params["block_gating"][:, 1] > params["block_gating"][:, 0])
    gating = torch.stack([1.0 - keep.float(), keep.float()], dim=-1)
    served = apply_compact(layers, top, x, cfg,
                           token_ratio=token_ratio).logits
    dense = tvit.apply(params, x, cfg, gating_distrib=gating, masks=masks,
                       patch_gate_mode=2 if token_ratio else 0,
                       patch_ratio=token_ratio or 1.0, patch_physical=True,
                       dtype=torch.bfloat16).logits
    rel = float((served - dense).norm() / dense.norm())
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("case", ["dp", "mp", "processes", "stablehlo",
                                  "baseline_dp", "baseline_processes"])
def test_unported_routes_raise(tmp_path, monkeypatch, case):
    """The routes that were refused before the model axis and the export
    were ported: a ``--dp x --mp`` mesh other than the world (one process
    here) raises JAX's ValueError, with the model axis too, and
    ``--num_processes 2`` with no coordinator raises at once, before any
    rendezvous; ``--export_stablehlo`` now writes the ``torch.export``
    artifact, which serves the exported compact model's logits bit for
    bit at each of ``--serve_batches``."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    base = TINY + ["--device", "cpu", "--output_dir", str(tmp_path)]
    from uvc_tpu_torch.cli import baseline_train as t_base
    no_coordinator = (ValueError, "needs --coordinator")
    calls = {
        "dp": (t_joint.main, base + ["--dp", "2"], ValueError,
               r"dp\(2\) \* mp\(1\) != device count \(1\)"),
        "mp": (t_joint.main, base + ["--dp", "1", "--mp", "2"], ValueError,
               r"dp\(1\) \* mp\(2\) != device count \(1\)"),
        "processes": (t_joint.main, base + ["--num_processes", "2"])
        + no_coordinator,
        "baseline_dp": (t_base.main, base + ["--dp", "4", "--mp", "2"],
                        ValueError,
                        r"dp\(4\) \* mp\(2\) != device count \(1\)"),
        "baseline_processes": (t_base.main,
                               base + ["--num_processes", "2"])
        + no_coordinator,
    }
    if case == "stablehlo":
        from uvc_tpu_torch.infer.compact import apply_compact
        from uvc_tpu_torch.infer.export import load_serving
        ckpt, out = tmp_path / "s1.ckpt", tmp_path / "compact.ckpt"
        art = tmp_path / "serve.npz"
        _jax_stage1_ckpt(ckpt)
        t_export.main(["--model_type", "testing", "--checkpoint", str(ckpt),
                       "--save_file", str(out), "--img_size", "32",
                       "--device", "cpu", "--export_stablehlo", str(art),
                       "--serve_batches", "2,4"])
        model = load_serving(str(art))
        assert model.batch_sizes == [2, 4]
        layers, top, _ = _serve_export(out)
        cfg = tconfigs.get_config("testing").replace(num_classes=1000)
        x = torch.randn(3, 32, 32, 3,
                        generator=torch.Generator().manual_seed(2))
        want = apply_compact(layers, top, x.to(torch.bfloat16), cfg).logits
        assert torch.equal(model(x), want)
        return
    main, argv, err, match = calls[case]
    with pytest.raises(err, match=match):
        main(argv)
    assert not torch.distributed.is_initialized()


def _testing_npz(path, cfg):
    """An upstream-layout ViT ``.npz`` of the testing model, seeded
    random weights, a 1000-class head."""
    d, f, p = cfg.embed_dim, cfg.mlp_hidden, cfg.patch_size
    h, dh = cfg.num_heads, cfg.head_size
    rng = np.random.default_rng(11)

    def rn(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    w = {"embedding/kernel": rn(p, p, 3, d), "embedding/bias": rn(d),
         "cls": rn(1, 1, d),
         "Transformer/posembed_input/pos_embedding": rn(1, cfg.seq_len, d),
         "Transformer/encoder_norm/scale": 1 + rn(d),
         "Transformer/encoder_norm/bias": rn(d),
         "head/kernel": rn(d, 1000), "head/bias": rn(1000)}
    at = "Transformer/encoderblock_{}/MultiHeadDotProductAttention_1"
    for i in range(cfg.depth):
        pre = f"Transformer/encoderblock_{i}"
        for nm in ("query", "key", "value"):
            w[f"{at.format(i)}/{nm}/kernel"] = rn(d, h, dh)
            w[f"{at.format(i)}/{nm}/bias"] = rn(h, dh)
        w[f"{at.format(i)}/out/kernel"] = rn(h, dh, d)
        w[f"{at.format(i)}/out/bias"] = rn(d)
        w[f"{pre}/MlpBlock_3/Dense_0/kernel"] = rn(d, f)
        w[f"{pre}/MlpBlock_3/Dense_0/bias"] = rn(f)
        w[f"{pre}/MlpBlock_3/Dense_1/kernel"] = rn(f, d)
        w[f"{pre}/MlpBlock_3/Dense_1/bias"] = rn(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{pre}/{ln}/scale"] = 1 + rn(d)
            w[f"{pre}/{ln}/bias"] = rn(d)
    np.savez(path, **w)


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_joint_train_starts_from_converted_weights(tmp_path, monkeypatch,
                                                   kind):
    """``joint_train --model_path`` a timm ``.pth`` or an upstream
    ``.npz``: stage 1 starts from (and distils from) the converted
    weights, JAX's converter's leaf for leaf."""
    from uvc_tpu.models import convert as jconvert
    from uvc_tpu_torch.models import convert as tconvert
    from uvc_tpu_torch.train import stage1
    from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path
    jcfg = jconfigs.get_config("testing").replace(num_classes=1000)
    tcfg = tconfigs.get_config("testing").replace(num_classes=1000)
    path = str(tmp_path / f"w.{kind}")
    if kind == "pth":
        params = jax.tree.map(np.asarray,
                              jvit.init_params(jax.random.PRNGKey(5), jcfg))
        rng = np.random.default_rng(5)
        params = jax.tree.map(
            lambda a: (0.2 * rng.standard_normal(a.shape)).astype(
                np.float32), params)
        torch.save({"model": tconvert.to_torch_state_dict(
            jax.tree.map(torch.from_numpy, params), tcfg)}, path)
        ref = jconvert.load_torch_checkpoint(path, jcfg)
    else:
        _testing_npz(path, jcfg)
        ref = jconvert.load_npz_checkpoint(path, jcfg)
    seen = {}
    real = stage1.run_stage1

    def spy(*args, **kw):
        seen["params"] = kw["params"]
        seen["teacher"] = kw["teacher_params"]
        return real(*args, **kw)

    monkeypatch.setattr(stage1, "run_stage1", spy)
    t_joint.main(TINY + [
        "--synthetic_steps", "2", "--num_epochs", "1", "--warmup_epochs",
        "1", "--post_num_epochs", "0", "--warmup_steps", "1",
        "--enable_patch_gating", "0", "--distillation-type", "soft",
        "--model_path", path, "--dp", "1", "--device", "cpu",
        "--output_dir", str(tmp_path), "--name", kind])
    for tree in (seen["params"], seen["teacher"]):
        for p, leaf in tree_leaves_with_path(tree):
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(leaf_at(ref, p)), err_msg=str(p))
    ck = load_checkpoint(str(tmp_path / kind / "testing_1.ckpt"))
    assert int(ck["global_step"]) == 2


def test_metric_logger_writes_what_jax_writes(tmp_path):
    """The same metrics.jsonl records and s_ / r_ / gating_ series."""
    files = {}
    for name, mod, series in (
            ("jax", jlogging, lambda v: jnp.asarray(v)),
            ("port", tlogging, lambda v: torch.tensor(v))):
        log = mod.MetricLogger(str(tmp_path), name)
        log.log_scalars(3, {"train/loss": 1.5, "note": "text",
                            "t": series(0.25)})
        log.log_series("s", 3, series([[1.0, 2.0]]))
        log.log_series("s", 7, series([[3.0, 4.0]]))
        files[name] = (
            (tmp_path / name / "metrics.jsonl").read_text(),
            json.loads((tmp_path / name / f"s_{log.run_id}.json")
                       .read_text()))
    assert files["jax"] == files["port"]
    meter = tlogging.AverageMeter()
    meter.update(2.0, n=3)
    meter.update(torch.tensor(4.0))
    assert meter.avg == pytest.approx(2.5) and meter.count == 4
    assert tlogging.is_main_process()


def test_step_profiler_writes_a_trace(tmp_path):
    prof = tprofiler.from_args(argparse.Namespace(
        profile_dir=str(tmp_path / "trace"), profile_start=2,
        profile_steps=2))
    assert tprofiler.from_args(argparse.Namespace()) is None
    for step in range(6):
        prof.step(step)
        torch.randn(64, 64) @ torch.randn(64, 64)
        assert prof.active == (2 <= step < 4)
    prof.close()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    inert = tprofiler.StepProfiler(None)
    inert.step(100)
    assert not inert.active and inert.done


def test_new_modules_import_no_jax_or_msgpack():
    """Importing the port's data, checkpoint, logging, profiler, driver,
    CLI, serving-export and parallel modules (the mesh, the dry run, the
    SLURM launcher), the image library, ``data_bench`` and the test-side
    ``image_check`` that the card runs, the evidence harnesses and the
    examples loads neither JAX, flax, optax, msgpack, ml_dtypes, PIL, yaml
    nor the JAX package."""
    code = (
        "import sys\n"
        "import uvc_tpu_torch.data.pipeline, uvc_tpu_torch.data.augment\n"
        "import uvc_tpu_torch.data.native_loader\n"
        "import uvc_tpu_torch.data.imagelib\n"
        "sys.path.insert(0, 'tests'); import image_check\n"
        "import uvc_tpu_torch.scripts.data_bench\n"
        "import uvc_tpu_torch.utils.checkpoint, uvc_tpu_torch.utils.logging\n"
        "import uvc_tpu_torch.utils.profiler\n"
        "import uvc_tpu_torch.train.stage1, uvc_tpu_torch.train.stage2\n"
        "import uvc_tpu_torch.cli.flags, uvc_tpu_torch.cli.joint_train\n"
        "import uvc_tpu_torch.cli.post_train\n"
        "import uvc_tpu_torch.cli.export_compact\n"
        "import uvc_tpu_torch.models.resnet, uvc_tpu_torch.models.cait\n"
        "import uvc_tpu_torch.parallel, uvc_tpu_torch.parallel.mesh\n"
        "import uvc_tpu_torch.parallel.dryrun, uvc_tpu_torch.infer.export\n"
        "import uvc_tpu_torch.cli.slurm_launch\n"
        "import uvc_tpu_torch.scripts.e2e_accuracy\n"
        "import uvc_tpu_torch.scripts.trajectory_fidelity\n"
        "import uvc_tpu_torch.examples.learning_demo\n"
        "import uvc_tpu_torch.examples.serving_demo\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'ml_dtypes',"
        " 'uvc_tpu', 'PIL', 'yaml'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_modules_run_as_scripts():
    """``python -m uvc_tpu_torch.cli.<name> --help`` runs (the modules
    have their ``__main__`` guards)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in ("joint_train", "post_train", "export_compact"):
        res = subprocess.run(
            [sys.executable, "-m", f"uvc_tpu_torch.cli.{name}", "--help"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert "--device" in res.stdout
