"""The port's baseline CLIs (uvc_tpu_torch/cli/{generate_mask,
baseline_train,show_gradient_sparsity}.py) and diagnostics against the
JAX package's, on the CPU (``--device cpu``).

The parsers take every JAX flag with its default.  ``generate_mask``
scores a JAX-written checkpoint on the CPU in f32 and writes JAX's mask
file: magnitude masks bit for bit, Taylor and SP masks equal but where a
score lies within 1e-5 (of the largest) of the cut, SynFlow's at the
requested density (its 100 rounds are held to JAX round by round in
``tests/test_torch_port_scorers.py``).  The labels a narrower head cannot
express are filtered out as JAX filters them.  A ``baseline_train`` run
from a ``.pth`` and a mask file resumes and evaluates, and JAX's
``--eval`` reads its checkpoint.  ``gradient_sparsity_stats`` and
``format_report`` give JAX's numbers and text.  The new modules import
no JAX.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu import diagnostics as jdiag
from uvc_tpu.baselines import pruning as jpruning
from uvc_tpu.cli import baseline_train as j_base
from uvc_tpu.cli import generate_mask as j_gen
from uvc_tpu.cli import show_gradient_sparsity as j_grad
from uvc_tpu.configs import get_config as jget_config
from uvc_tpu.models import vit as jvit
from uvc_tpu.utils.checkpoint import load_checkpoint as j_load
from uvc_tpu.utils.checkpoint import save_checkpoint as j_save
from uvc_tpu_torch import diagnostics as tdiag
from uvc_tpu_torch.baselines import pruning as tpruning
from uvc_tpu_torch.cli import baseline_train as t_base
from uvc_tpu_torch.cli import generate_mask as t_gen
from uvc_tpu_torch.cli import show_gradient_sparsity as t_grad
from uvc_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
GEN = ["--model_type", "testing", "--dataset", "synthetic",
       "--input_size", "32", "--batch_size", "4", "--num_batches", "2"]


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


@pytest.mark.parametrize("cli", ["generate_mask", "baseline_train",
                                 "show_gradient_sparsity"])
def test_parsers_take_every_jax_flag(grab_parser, cli):
    """Every flag of the JAX parser, with its option strings, default,
    type, choices, nargs and action; the port adds ``--device`` only."""
    mains = {"generate_mask": (j_gen.main, t_gen.main),
             "baseline_train": (j_base.main, t_base.main),
             "show_gradient_sparsity": (j_grad.main, t_grad.main)}[cli]
    jp, tp = ({a.dest: a for a in grab_parser(m, [])._actions
               if a.dest != "help"} for m in mains)
    assert set(tp) - set(jp) == {"device"}
    for dest, ja in jp.items():
        ta = tp[dest]
        for attr in ("option_strings", "default", "type", "choices",
                     "nargs", "const", "required"):
            assert getattr(ta, attr) == getattr(ja, attr), (dest, attr)
        assert type(ta) is type(ja), dest
    assert tp["device"].default == "cuda"


def _pretrained(path, num_classes=1000, seed=0):
    """A JAX-written ``.ckpt`` of the testing model with every kernel and
    bias drawn (a zero head makes every gradient score zero)."""
    cfg = jget_config("testing").replace(img_size=32,
                                         num_classes=num_classes)
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def draw(p, leaf):
        name = jax.tree_util.keystr(p)
        if "gating" in name or "scale" in name:
            return leaf
        return jnp.asarray(0.2 * rng.standard_normal(leaf.shape),
                           jnp.float32)

    params = jax.tree_util.tree_map_with_path(draw, params)
    j_save(str(path), {"params": params})
    return params


def _run_both(tmp_path, argv, capsys):
    """(JAX's mask file, the port's, the port's printed output)."""
    j_gen.main(argv + ["--save_file", str(tmp_path / "jax.ckpt")])
    capsys.readouterr()
    t_gen.main(argv + ["--save_file", str(tmp_path / "port.ckpt"),
                       "--device", "cpu"])
    out = capsys.readouterr().out
    return (j_load(str(tmp_path / "jax.ckpt")),
            load_checkpoint(str(tmp_path / "port.ckpt")), out)


def _remain(out):
    return float(re.search(r"remain weight = ([\d.]+) %", out).group(1))


@pytest.mark.parametrize("scope", ["global", "local"])
def test_generate_mask_mag_is_jax_file(tmp_path, capsys, scope):
    _pretrained(tmp_path / "w.ckpt")
    jm, tm, out = _run_both(tmp_path, GEN + [
        "--type", "mag", "--scope", scope, "--sparsity", "0.4",
        "--pretrained", str(tmp_path / "w.ckpt")], capsys)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    with open(tmp_path / "jax.ckpt", "rb") as a, \
            open(tmp_path / "port.ckpt", "rb") as b:
        assert a.read() == b.read()
    assert "saved mask to" in out
    if scope == "global":
        assert abs(_remain(out) - 40.0) < 0.5


def _jax_scores(params, kind, cfg, data):
    """JAX's Taylor scores of ``params`` on ``data`` (flat)."""
    def loss_fn(p, x, y):
        out = jvit.apply(p, x, cfg, train=True)
        logp = jax.nn.log_softmax(out.logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
    return jpruning.masks_to_flat(
        jpruning.taylor_scores(params, loss_fn, data), params)


def _scoring_data(cfg, batch=4, num_batches=2):
    from uvc_tpu.data.pipeline import SyntheticLoader, normalize_on_device
    loader = SyntheticLoader(batch, num_batches=num_batches, img_size=32,
                             num_classes=1000, seed=0)
    out = []
    for x, y in loader:
        keep = y < cfg.num_classes
        if keep.any():
            out.append((normalize_on_device(jnp.asarray(x[keep])),
                        jnp.asarray(y[keep])))
    return out


def _masks_agree_off_the_cut(tm, jm, scores, density):
    """Every coordinate but those within 1e-5 (of the largest score) of
    the global cut masked as JAX masks it; returns their number."""
    allv = np.concatenate([v.ravel() for v in scores.values()])
    cut = np.sort(allv)[int((1 - density) * allv.size) - 1]
    band = TOL * allv.max()
    near = 0
    for k in jm:
        close = np.abs(scores[k] - cut) <= band
        np.testing.assert_array_equal(tm[k].numpy()[~close],
                                      np.asarray(jm[k])[~close])
        near += int(close.sum())
    return near


@pytest.mark.parametrize("head_classes", [1000, 500])
def test_generate_mask_taylor_is_jax_file(tmp_path, capsys, head_classes):
    """Taylor over 2 batches; with a 500-class head, the labels past it
    are dropped (not aliased) in both packages."""
    params = _pretrained(tmp_path / "w.ckpt", num_classes=head_classes)
    jm, tm, out = _run_both(tmp_path, GEN + [
        "--type", "taylor", "--sparsity", "0.5", "--batch_size", "8",
        "--pretrained", str(tmp_path / "w.ckpt")], capsys)
    if head_classes != 1000:
        assert "filtered to labels" in out
    cfg = jget_config("testing").replace(img_size=32,
                                         num_classes=head_classes)
    data = _scoring_data(cfg, batch=8)
    kept = sum(len(y) for _, y in data)
    assert kept == 16 if head_classes == 1000 else 0 < kept < 16
    scores = _jax_scores(params, "taylor", cfg, data)
    near = _masks_agree_off_the_cut(tm, jm, scores, 0.5)
    assert near <= 0.05 * sum(v.size for v in scores.values())
    assert abs(_remain(out) - 50.0) < 1.0


def test_generate_mask_synflow_hits_the_density(tmp_path, capsys):
    params = _pretrained(tmp_path / "w.ckpt")
    jm, tm, out = _run_both(tmp_path, GEN + [
        "--type", "synflow", "--sparsity", "0.3",
        "--pretrained", str(tmp_path / "w.ckpt")], capsys)
    assert sorted(tm) == sorted(jm)
    total = sum(np.asarray(v).size for v in jm.values())
    kept = sum(float(v.sum()) for v in tm.values())
    jkept = sum(float(np.asarray(v).sum()) for v in jm.values())
    assert abs(kept / total - 0.3) <= 2 / total
    assert abs(jkept / total - 0.3) <= 2 / total
    assert abs(_remain(out) - 30.0) < 0.1
    # the CLI's masks are the scorer's on the checkpoint's weights
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.interop import params_from_numpy
    from uvc_tpu_torch.models import vit as tvit
    cfg = get_config("testing").replace(img_size=32, num_classes=1000)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")

    def forward_sum(p):
        return tvit.apply(p, torch.ones(1, 32, 32, 3), cfg, train=False,
                          dtype=torch.float32).logits.sum()

    _, ref = tpruning.synflow_scores(tp, forward_sum, 0.3, epochs=100)
    for k, m in tpruning.masks_to_flat(ref).items():
        np.testing.assert_array_equal(tm[k].numpy(), m)


def test_generate_mask_sp_is_jax_file(tmp_path, capsys):
    _pretrained(tmp_path / "w.ckpt")
    argv = ["--model_type", "testing", "--dataset", "synthetic",
            "--input_size", "32", "--batch_size", "8", "--num_batches", "1",
            "--type", "sp", "--atten_density", "0.5", "--mlp_density",
            "0.25", "--pretrained", str(tmp_path / "w.ckpt")]
    jm, tm, out = _run_both(tmp_path, argv, capsys)
    js = j_load(str(tmp_path / "jax.ckpt.structural"))
    ts = load_checkpoint(str(tmp_path / "port.ckpt.structural"))
    assert sorted(ts) == sorted(js) == ["attn", "mlp"]
    for k in ("attn", "mlp"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    assert float(ts["mlp"].sum()) == 8      # 0.25 of the 32 units


def test_generate_mask_refuses_when_no_label_fits(tmp_path, capsys):
    """A 10-class checkpoint scored on 1000-class synthetic data: the
    seed-0 batch of 4 has no label below 10, so both CLIs refuse."""
    _pretrained(tmp_path / "narrow.ckpt", num_classes=10)
    argv = GEN + ["--type", "taylor", "--num_batches", "1",
                  "--pretrained", str(tmp_path / "narrow.ckpt")]
    with pytest.raises(SystemExit, match="labels"):
        j_gen.main(argv + ["--save_file", str(tmp_path / "j.ckpt")])
    with pytest.raises(SystemExit, match="labels"):
        t_gen.main(argv + ["--save_file", str(tmp_path / "t.ckpt"),
                           "--device", "cpu"])
    assert "filtered to labels" in capsys.readouterr().out
    assert not (tmp_path / "t.ckpt").exists()


def test_generate_mask_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gen.main(GEN + ["--type", "mag", "--save_file",
                          str(tmp_path / "m.ckpt")])


def test_baseline_train_from_pth_resume_and_eval(tmp_path, capsys):
    """``--init_weight`` a ``.pth`` (its 1000-class head re-initialised
    for the 10 classes), ``--init_mask`` a magnitude mask, EMA on; the
    run resumed from its epoch-0 checkpoint writes the same epoch-1
    checkpoint; ``--eval --resume`` logs the same accuracy in both
    packages."""
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.interop import params_from_numpy
    from uvc_tpu_torch.models.convert import to_torch_state_dict
    params = _pretrained(tmp_path / "w.ckpt")
    cfg = get_config("testing").replace(img_size=32, num_classes=1000)
    torch.save({"model": to_torch_state_dict(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        cfg)}, tmp_path / "w.pth")
    t_gen.main(["--type", "mag", "--model_type", "testing", "--dataset",
                "cifar10", "--input_size", "32", "--pretrained",
                str(tmp_path / "w.pth"), "--save_file",
                str(tmp_path / "mask.ckpt"), "--device", "cpu"])
    common = ["--model_type", "testing", "--dataset", "procedural",
              "--img_size", "32", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--synthetic_steps", "3",
              "--epochs", "2", "--init_weight", str(tmp_path / "w.pth"),
              "--init_mask", str(tmp_path / "mask.ckpt"), "--model_ema",
              "1", "--output_dir", str(tmp_path), "--device", "cpu"]
    t_base.main(common + ["--name", "full"])
    full = tmp_path / "full" / "testing_baseline_1.ckpt"
    t_base.main(common + ["--name", "resumed", "--resume",
                          str(tmp_path / "full" / "testing_baseline_0.ckpt")])
    assert full.read_bytes() == (
        tmp_path / "resumed" / "testing_baseline_1.ckpt").read_bytes()
    out = capsys.readouterr().out
    assert re.search(r"\[Baseline Epoch 1\] [\d.]+s \([\d.]+ img/s\)", out)
    ck = load_checkpoint(str(full))
    assert int(ck["step"]) == 6 and int(ck["epoch"]) == 1
    mask = load_checkpoint(str(tmp_path / "mask.ckpt"))
    assert sorted(ck["masks"]) == sorted(mask)
    # the masked coordinates' weights stay as they are multiplied in; their
    # AdamW first moments are exactly 0
    mu = ck["opt_state"]["0"]["mu"]
    for k, m in mask.items():
        node = mu
        for part in k.split("."):
            node = node[part]
        assert not node[m == 0].any(), k
    evals = []
    for mod, extra in ((t_base, ["--device", "cpu"]), (j_base, [])):
        mod.main(["--model_type", "testing", "--dataset", "procedural",
                  "--img_size", "32", "--eval_batch_size", "8",
                  "--train_batch_size", "8", "--synthetic_steps", "1",
                  "--eval", "--resume", str(full), "--output_dir",
                  str(tmp_path), "--name", "eval", "--dp", "1"] + extra)
        evals.append(re.findall(r"Eval accuracy ([\d.]+)%",
                                capsys.readouterr().out))
    assert evals[0] and evals[0] == evals[1]


def test_show_gradient_sparsity_reports_as_jax(tmp_path, capsys):
    _pretrained(tmp_path / "w.ckpt", num_classes=1000)
    argv = ["--model_type", "testing", "--dataset", "synthetic",
            "--img_size", "32", "--train_batch_size", "4",
            "--num_batches", "2", "--model_path", str(tmp_path / "w.ckpt"),
            "--top", "40"]
    reports = []
    for main, extra in ((j_grad.main, []), (t_grad.main, ["--device",
                                                          "cpu"])):
        main(argv + extra)
        reports.append(capsys.readouterr().out.strip().splitlines())
    jrep, trep = reports
    assert trep[0] == jrep[0]

    def zeros(lines):
        return {ln.split()[0]: float(ln.split()[1][:-1]) for ln in lines}

    # every leaf listed (--top 40 covers them all), in the order of its
    # zero share; bf16 forwards in both, so an exactly-zero gradient leaf
    # is zero in both and a dense one dense in both
    tz, jz = zeros(trep[1:-1]), zeros(jrep[1:-1])
    assert sorted(tz) == sorted(jz) and len(tz) == len(trep) - 2
    for name in jz:
        assert abs(tz[name] - jz[name]) < 5.0, name
    assert list(tz.values()) == sorted(tz.values(), reverse=True)
    fa = float(re.search(r"([\d.]+)%", trep[-1]).group(1))
    fb = float(re.search(r"([\d.]+)%", jrep[-1]).group(1))
    assert abs(fa - fb) < 1.0


def test_gradient_sparsity_stats_and_report_match_jax():
    rng = np.random.default_rng(0)
    grads = {"blocks": {"qkv": {"kernel": rng.standard_normal((2, 8, 24)),
                                "bias": np.zeros((2, 24))}},
             "head": {"kernel": np.where(rng.random((8, 10)) < 0.3, 0.0,
                                         rng.standard_normal((8, 10))),
                      "bias": 1e-4 * rng.standard_normal(10)},
             "cls_token": rng.standard_normal((1, 1, 8))}
    grads = jax.tree.map(lambda a: a.astype(np.float32), grads)
    for thr in (0.0, 1e-3):
        js = jdiag.gradient_sparsity_stats(
            jax.tree.map(jnp.asarray, grads), threshold=thr)
        ts = tdiag.gradient_sparsity_stats(
            jax.tree.map(torch.from_numpy, grads), threshold=thr)
        assert list(ts) == list(js)
        for name in js:
            assert ts[name]["size"] == js[name]["size"]
            for k in ("zeros", "near_zeros", "l1", "l2", "max"):
                assert ts[name][k] == pytest.approx(js[name][k], rel=1e-6,
                                                    abs=1e-12), (name, k)
        assert tdiag.aggregate_sparsity(ts) == pytest.approx(
            jdiag.aggregate_sparsity(js), rel=1e-9)
        for top in (2, 20):
            assert tdiag.format_report(ts, top) == \
                jdiag.format_report(js, top)


def test_new_modules_import_no_jax():
    """Importing the baseline suite's modules and the converters loads
    neither JAX, flax, optax, msgpack nor the JAX package."""
    code = (
        "import sys\n"
        "import uvc_tpu_torch.baselines.pruning\n"
        "import uvc_tpu_torch.baselines.finetune\n"
        "import uvc_tpu_torch.cli.generate_mask\n"
        "import uvc_tpu_torch.cli.baseline_train\n"
        "import uvc_tpu_torch.cli.show_gradient_sparsity\n"
        "import uvc_tpu_torch.diagnostics, uvc_tpu_torch.models.convert\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'uvc_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["generate_mask", "baseline_train",
                                  "show_gradient_sparsity"])
def test_cli_modules_run_as_scripts(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", f"uvc_tpu_torch.cli.{name}", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout
