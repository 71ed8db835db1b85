"""Tensor parallelism of the port (the model axis of
uvc_tpu_torch/parallel/mesh.py, through the steps, drivers, CLIs and the
dry run) on the CPU, against the JAX package.

The JAX package shards the stacked ``'blocks'`` kernels Megatron-style
over the ``model`` axis of a ``(data, model)`` mesh and runs one SPMD
program over the global batch; its Pallas kernels run whole on every
device of a model group.  The port's rank at (d, m) holds the shard JAX's
device at (d, m) holds, gathers the whole weights for each step, and
updates its shard.  So the references are the ones of the data-parallel
tests (``test_torch_port_ddp.py``, whose spec builders this module
shares): JAX's single-process steps on the same global batches with
JAX's draws fed in, held to the same tolerances; four gloo ranks at 2 dp
x 2 mp run every spec in one launch.  After every step all four ranks
hold the same whole state (a digest of the gathered state), and between
steps each holds half the bytes of the tensor-parallel leaves.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import shutil

import numpy as np
import pytest
import torch

import jax

import uvc_tpu.configs as jconfigs
from uvc_tpu.models import get_model as jget_model
from uvc_tpu.parallel import mesh as jmesh
from uvc_tpu.utils.checkpoint import load_checkpoint as jload
from uvc_tpu_torch.interop import params_from_numpy
from uvc_tpu_torch.parallel import dryrun, mesh as pmesh
from uvc_tpu_torch.train import stage2 as tstage2
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.models import get_model as tget_model

from test_torch_port_ddp import (JOINT, STAGE1, TOL, _baseline_case,
                                 _cli, _compare, _eval_case, _stage1_case,
                                 _stage2_case)

DP, MP = 2, 2
WORLD = DP * MP
LR = 1e-2
STATE_TOL = 1e-5

MODELS = {
    "deit": ("deit_tiny_patch16_224", dict(img_size=32, depth=2)),
    "t2t": ("t2t_vit_14", dict(img_size=32, depth=2, num_classes=10)),
    "se": ("t2t_vit_14_se", dict(img_size=64, embed_dim=32, depth=2,
                                 num_heads=2, token_dim=16, num_classes=5)),
    "r50": ("R50-ViT-B_16", dict(img_size=64, depth=2, embed_dim=64,
                                 num_heads=2, num_classes=7,
                                 resnet_layers=(1, 1, 1))),
    "cait": ("cait_S24_224", dict(img_size=32, depth=2, num_classes=10)),
}


def _jax_params(name):
    model, cut = MODELS[name]
    cfg = jconfigs.get_config(model).replace(**cut)
    params = jget_model(cfg).init_params(jax.random.PRNGKey(0), cfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_partition_spec_marks_jax_leaves(name):
    """Every leaf's spec, by its ``keystr``, is JAX's: the six stacked
    block leaves of the ViT families sharded (CaiT's talking-heads
    ``proj_l`` / ``proj_w`` kernels too, by JAX's substring rule), the SE
    ablation's ``'ablation_blocks'`` and the stems replicated."""
    model, cut = MODELS[name]
    jcfg = jconfigs.get_config(model).replace(**cut)
    tcfg = tconfigs.get_config(model).replace(**cut)
    # the trees' layouts only: JAX's shapes, the port's on the meta device
    jparams = jax.eval_shape(lambda: jget_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))
    tparams = tget_model(tcfg).init_params(torch.Generator(), tcfg,
                                           device="meta")
    want = {jax.tree_util.keystr(path): tuple(jmesh.param_partition_spec(
        jax.tree_util.keystr(path), leaf, MP))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {path: pmesh.param_partition_spec(path, leaf, MP)
           for path, leaf in pmesh._keyed_leaves(tparams)}
    assert got == want
    sharded = sorted(p for p, spec in got.items() if spec)
    assert len(sharded) == {"se": 0, "cait": 8}.get(name, 6), sharded
    assert all(not spec for spec in (pmesh.param_partition_spec(
        p, None, 1) for p in got))


def test_shards_are_jax_addressable_shards():
    """The rank at (d, m) holds, leaf for leaf and bit for bit, what
    ``shard_params`` puts on JAX's device at (d, m) of a 4 x 2 mesh of
    virtual CPU devices; the whole leaves gather back from the model
    index's chunks."""
    jparams, tparams = _jax_params("deit")
    jm = jmesh.make_mesh(dp=4, mp=2)
    where = {dev: tuple(int(i) for i in pos)
             for pos, dev in np.ndenumerate(jm.devices)}
    with jm:
        sharded = jmesh.shard_params(jparams, jm, mp=2)
    flat = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(sharded)[0]}
    for rank in range(8):
        ours = dict(pmesh._keyed_leaves(pmesh.shard_params(
            tparams, pmesh.Mesh(size=8, rank=rank, mp=2), 2)))
        assert sorted(ours) == sorted(flat)
        for path, arr in flat.items():
            shard = next(s for s in arr.addressable_shards
                         if where[s.device] == (rank // 2, rank % 2))
            np.testing.assert_array_equal(ours[path].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{path} rank {rank}")
    # a mesh whose model axis is not the asked one raises
    with pytest.raises(ValueError, match="model axis"):
        pmesh.shard_params(tparams, pmesh.Mesh(size=8, rank=0, mp=4), 2)
    assert pmesh.shard_params(tparams, pmesh.Mesh(size=8, rank=0), 1) \
        is tparams


CASES = {
    "stage1": lambda: _stage1_case(1, 4, warmup=1),
    "stage2": lambda: _stage2_case("stage2", 3, 2),
    "baseline": lambda: _baseline_case(7, 2),
    "eval": _eval_case,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's spec run by four gloo ranks at 2 dp x 2 mp in one
    launch: per case (settings, arrays, JAX's history, the ranks'
    results, the spec file)."""
    tmp = tmp_path_factory.mktemp("tp")
    cases, paths = {}, []
    for name, make in CASES.items():
        settings, trees, history = make()
        path = str(tmp / f"{name}.npz")
        dryrun.write_spec(path, settings, **trees)
        cases[name] = (settings, trees, history)
        paths.append(path)
    ranks = dryrun.launch_ranks(WORLD, device="cpu", tasks=paths, threads=1,
                                timeout=300, wait=False, mp=MP)
    # the same specs at the same data split without the model axis
    dp_paths = [p.replace(".npz", "_dp.npz") for p in paths]
    for src, dst in zip(paths, dp_paths):
        shutil.copy(src, dst)
    dp_ranks = dryrun.launch_ranks(DP, device="cpu", tasks=dp_paths,
                                   threads=1, timeout=300, wait=False)
    cases = {name: (settings, trees, history and history())
             for name, (settings, trees, history) in cases.items()}
    ranks.wait()
    dp_ranks.wait()
    return {name: cases[name] + (dryrun.read_rank_results(p, WORLD), p,
                                 dryrun.read_rank_results(q, DP))
            for name, p, q in zip(CASES, paths, dp_paths)}


def _four_ranks_against_jax(case, full_steps):
    _, _, hist, ranks, _, dp_ranks = case
    results = [res for res, _ in ranks]
    # the whole state after every step: the same bytes on every rank, and
    # the bytes of the data-parallel run at the same data split (the model
    # axis moves where the weights live, not what a step computes)
    for res in results[1:] + [r for r, _ in dp_ranks]:
        assert res["digests"] == results[0]["digests"]
    # between steps a rank holds half the bytes of the sharded leaves
    for res in results:
        local, whole = res["tp_bytes"]
        assert whole > 0 and 2 * local == whole
    res, arrays = ranks[0]
    assert len(res["metrics"]) == full_steps
    for i, m in enumerate(res["metrics"]):
        for k, v in m.items():
            np.testing.assert_allclose(v, np.asarray(hist[i][0][k],
                                                     np.float64),
                                       rtol=TOL, atol=1e-6, err_msg=k)
    _, jparams, jcstate = hist[-1]
    _compare(arrays, "params", jparams, TOL, key_bias=LR * full_steps)
    if jcstate is not None:
        for f in ("s", "r", "y", "p", "z", "gating_accum"):
            np.testing.assert_allclose(arrays[f"cstate/{f}"],
                                       np.asarray(getattr(jcstate, f)),
                                       rtol=STATE_TOL, atol=STATE_TOL,
                                       err_msg=f)
    return results


@pytest.mark.parametrize("kind,steps", [("stage1", 4), ("stage2", 2),
                                        ("baseline", 2)])
def test_four_ranks_at_2dp_2mp_match_jax(runs, kind, steps):
    """Stage 1 (a warmup and three UVC steps: gating, token top-k,
    mixup against the flipped global batch), dense stage 2 with the token
    drop, and the baseline step with drop-path and EMA, at 2 dp x 2 mp:
    every step's metrics, the weights and the minimax state against JAX's
    single-process steps, and bit for bit the 2 dp x 1 mp run; the
    gradient all-reduce once a step over the data group, the weights
    gathered over the model group."""
    results = _four_ranks_against_jax(runs[kind], steps)
    for res in results:
        assert res["reduce"]["calls"] == steps
        assert res["gather"]["calls"] > 0


def test_forward_at_mp_2_matches_the_replicated_one(runs):
    """The eval forward on the gathered weights at 2 dp x 2 mp (each data
    index evaluating its shard of 13 images, padded) gives the
    one-process totals."""
    _, _, _, ranks, path, _ = runs["eval"]
    ref, _ = dryrun.run_spec(*dryrun.read_npz(path), device="cpu")
    for res, _ in ranks:
        correct, loss_sum, count = res["eval"]
        assert count == ref["eval"][2] == 13
        assert correct == ref["eval"][0]
        np.testing.assert_allclose(loss_sum, ref["eval"][1], rtol=1e-5)


def test_compact_stage2_refuses_a_model_axis():
    """Compact stage 2 takes data-parallel meshes only, with JAX's
    ValueError."""
    with pytest.raises(ValueError, match=r"compact stage-2 supports "
                                         r"data-parallel meshes only"):
        tstage2.run_stage2(
            tconfigs.get_config("testing"), THParams(),
            tstate.TrainHParams(), params={}, masks={}, train_loader=[],
            test_loader=None, mesh=pmesh.Mesh(size=4, rank=1, mp=2), mp=2,
            compact=True, device="cpu")


def test_joint_train_mp_2_writes_the_one_process_checkpoints(
        tmp_path):
    """``joint_train --mp 2`` as two ranks (1 dp x 2 mp): rank 0 alone
    writes the gathered trees, the same bytes as the one-process run's
    files (a data shard of the whole batch, gathered weights, an
    elementwise update of each shard), which JAX's ``load_checkpoint``
    reads with the whole leaves' shapes."""
    joint = "uvc_tpu_torch.cli.joint_train"
    runs = [_cli(tmp_path, "mp", joint, JOINT + ["--mp", "2"],
                 "coordinator"),
            dryrun.start_ranks(
                1, JOINT + ["--output_dir", str(tmp_path / "one")],
                module=joint, env_for=lambda r: {"OMP_NUM_THREADS": "1"},
                timeout=300)]
    outs = [r.wait() for r in runs]
    assert "Mesh: {'data': 1, 'model': 2}" in outs[0][0]
    r0, r1 = tmp_path / "mp" / "r0", tmp_path / "mp" / "r1"
    assert not list(r1.rglob("*.ckpt"))
    for f in STAGE1:
        assert (r0 / f).read_bytes() == (tmp_path / "one" / f).read_bytes()
    ck = jload(str(r0 / STAGE1[1]))
    qkv = ck["params"]["blocks"]["qkv"]["kernel"]
    cfg = jconfigs.get_config("testing")
    assert qkv.shape == (cfg.depth, cfg.embed_dim, 3 * cfg.embed_dim)
    assert ck["opt_state"]["0"]["mu"]["blocks"]["fc1"]["kernel"].shape == \
        (cfg.depth, cfg.embed_dim, cfg.mlp_hidden)


def test_dryrun_eight_ranks_prints_the_tp_mesh():
    """``python -m uvc_tpu_torch.parallel.dryrun --ranks 8`` runs stage 1,
    stage 2 and compact_ft (its compact tree replicated) at 4 dp x 2 mp,
    the JAX dry run's mesh for eight devices."""
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-m", "uvc_tpu_torch.parallel.dryrun", "--ranks",
         "8", "--device", "cpu", "--timeout", "300"], cwd=dryrun.REPO,
        capture_output=True, text=True, timeout=400,
        env=dict(__import__("os").environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=dryrun.REPO))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for stage in ("stage1", "stage2", "compact_ft"):
        assert f"dryrun_multiprocess(8) {stage} ok: mesh=(4 dp x 2 mp)" \
            in res.stdout
    assert "dryrun_multiprocess(8) ok: stage1+stage2+compact_ft on " \
        "(4 dp x 2 mp)" in res.stdout
    assert dryrun.dryrun_model_axis(8) == 2
    assert [dryrun.dryrun_model_axis(n) for n in (1, 2, 3, 6)] == \
        [1, 1, 1, 2]
