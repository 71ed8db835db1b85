"""Data parallelism of the port (uvc_tpu_torch/parallel/mesh.py, the mesh
through the steps, drivers and CLIs) on the CPU: two ranks joined by
gloo, started as ``python -m uvc_tpu_torch.parallel.dryrun`` ranks (one
launch runs every spec of the module; each rank writes what each step
gave).

The JAX package's step is one SPMD program over the global batch, so the
references are single-process runs on the same global batches: JAX's
``build_stage1_step`` / ``build_stage2_step`` / ``build_compact_stage2_step``
/ ``build_baseline_step`` with their own draws fed to the ranks (each
rank keeping its rows of the global draws), and, for the port's own
draws (the ``elem`` / ``pair`` mixup, whose partners lie on the other
rank), the port's single-process run of the same spec.  After every step
the two ranks hold the same bytes (a digest of the whole state).

Tolerances: the metrics and every weight leaf 1e-4 relative (the
trajectory tolerance of ``test_torch_port_train.py``: the ranks' mean of
two half-batch means sums in another order than one global mean), the
minimax state 1e-5.  Two leaves have a zero gradient in exact arithmetic,
so their f32 values are rounding noise that AdamW divides by its own
magnitude: the key bias (the middle third of the qkv bias: the softmax
over keys ignores a shift shared by all keys) and the token scorer's bias
(the top-k ignores a shift shared by all scores).  They are held to the
learning rate times the steps taken.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.baselines import finetune as jfinetune
from uvc_tpu.compress import minimax as jminimax
from uvc_tpu.compress import resource as jresource
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.train import compact_ft as jcft
from uvc_tpu.train import stage2 as jstage2
from uvc_tpu.train import state as jstate
from uvc_tpu.train import step as jstep
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress import masks as tmasks
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.data import pipeline as tpipe
from uvc_tpu_torch.data.mixup import rows_of_draw
from uvc_tpu_torch.parallel import dryrun, mesh as pmesh
from uvc_tpu_torch.train import stage2 as tstage2
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train import step as tstep
from uvc_tpu_torch.utils.checkpoint import load_checkpoint
from uvc_tpu_torch.utils.tree import tree_map

WORLD = 2
GLOBAL = 8
TOL = 1e-4
STATE_TOL = 1e-5
LR = 1e-2
CUT = dict(embed_dim=16, num_heads=2, depth=3, num_classes=7,
           distilled=True)
JCFG = jconfigs.get_config("testing").replace(**CUT)
TCFG = tconfigs.get_config("testing").replace(**CUT)
HP1 = dict(budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
           zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5,
           gating_weight=0.5, gating_interval=2, soptim="sgd",
           roptim="sgd", flops_with_mhsa=True, use_gumbel=True,
           enable_patch_gating=2, patch_ratio=0.75)
THP = dict(num_classes=7, learning_rate=LR, warmup_steps=2, t_total=20,
           mixup=0.8, cutmix=1.0, smoothing=0.1)
TAU = 5.0


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix):
    out = {}
    dryrun._flatten(np_tree(tree), prefix, out)
    return out


def _images(seed, steps, b=GLOBAL):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((steps, b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 7, (steps, b)).astype(np.int32))


def _jthp(**kw):
    return jstate.TrainHParams(compute_dtype=jnp.float32, **dict(THP, **kw))


def _settings(kind, hp=None, warmup=0, **thp):
    return dict(kind=kind, model="testing", cfg=CUT, hp=hp or {},
                thp=dict(THP, compute_dtype="float32", **thp), tau=TAU,
                warmup=warmup, return_state=True)


@functools.lru_cache(maxsize=None)
def _mix_sampler(alpha, cut_alpha, prob, switch_prob):
    return jax.jit(lambda k: jmixup._sample_one(
        k, 32, 32, alpha, cut_alpha, prob, switch_prob, None))


def _mix(k_mix, jthp):
    """The JAX mixup draw of ``k_mix`` (``cutmix_minmax`` unset)."""
    lam, blend, box = _mix_sampler(jthp.mixup, jthp.cutmix, jthp.mixup_prob,
                                   jthp.mixup_switch_prob)(k_mix)
    return {"lam": np.asarray(lam, np.float32),
            "use_blend": np.asarray(bool(blend)),
            "box": np.asarray(box)}


@jax.jit
def _gumbels(key):
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)
    l2 = (JCFG.depth, 2)

    def g(k, shape):
        return jax.random.gumbel(k, shape, jnp.float32)

    return k_mix, dict(gate=g(k_gate, l2),
                       token=g(k_tok, (GLOBAL, JCFG.num_patches)),
                       res1=g(k_res1, l2), res2=g(k_res2, l2),
                       part_attn=g(k_part1, l2), part_mlp=g(k_part2, l2))


def _stage1_noise(key, jthp):
    """The JAX stage-1 step's draws of the global batch, along its key
    chain (``test_torch_port_train.py``)."""
    k_mix, out = _gumbels(key)
    out = np_tree(out)
    if jthp.mixup > 0 or jthp.cutmix > 0:
        out["mixup"] = _mix(k_mix, jthp)
    return out


def _params(seed):
    """Seeded weights of the cut testing model (the port's ``init_params``,
    in the JAX package's layout and init rules, as numpy) with random
    classifier heads: the zero-initialised heads would make the
    distillation head's gradient zero up to rounding."""
    params = np_tree(tree_map(lambda t: t.numpy(), tvit.init_params(
        torch.Generator().manual_seed(seed), TCFG, device="cpu")))
    rng = np.random.default_rng(seed)
    for k in ("head", "head_dist"):
        params[k]["kernel"] = (0.1 * rng.standard_normal(
            params[k]["kernel"].shape)).astype(np.float32)
    return params


def _stage1_case(seed, steps, warmup, accum=1):
    """A stage-1 spec and JAX's states after each (full) step."""
    jhp = JHParams(**HP1)
    jthp = _jthp(accum_steps=accum)
    params = _params(seed)
    teacher = _params(seed + 9)
    table = jresource.build_macs_table(JCFG)
    build = {(w, m): jstep.build_stage1_step(JCFG, table, jhp, jthp,
                                             warmup=w, micro=m, donate=False)
             for w in (True, False) for m in (False, True)}
    x, y = _images(seed, steps)
    keys = [jax.random.PRNGKey(100 * seed + i) for i in range(steps)]

    def history():
        st = jstate.create_train_state(
            params, jthp, jminimax.init_compression_state(JCFG, jhp))
        hist = []
        for i, key in enumerate(keys):
            micro = accum > 1 and (i + 1) % accum != 0
            st, m = build[(i < warmup, micro)](
                st, teacher, jnp.asarray(x[i]), jnp.asarray(y[i]), key,
                jnp.float32(TAU))
            hist.append((np_tree(m), np_tree(st.params), np_tree(st.cstate)))
        return hist

    noise = {str(i): _stage1_noise(k, jthp) for i, k in enumerate(keys)}
    settings = _settings("stage1", HP1, warmup, accum_steps=accum)
    return settings, dict(params=params, teacher=teacher, x=x, labels=y,
                          noise=noise), history


def _stage2_setup(seed):
    """``test_torch_port_stage2.py``'s configuration: one head of layer 0
    and half the MLP units pruned, block 2 gated off."""
    params = _params(seed)
    s = torch.tensor([[1.0, 32.0], [0.0, 32.0], [0.0, 32.0]])
    r = torch.tensor([[0.0, 0.0], [2.0, 0.0], [0.0, 0.0]])
    masks = {k: v.numpy() for k, v in tmasks.build_masks(
        params_from_numpy(params, device="cpu"), s, r, TCFG).items()}
    params["block_gating"] = np.array([[-1.0, 1.0], [-1.0, 1.0],
                                       [1.0, -1.0]], np.float32)
    teacher = _params(seed + 9)
    return params, masks, teacher


def _stage2_case(kind, seed, steps):
    hp = dict(enable_patch_gating=2, patch_ratio=0.7)
    jhp, jthp = JHParams(**hp), _jthp()
    params, masks, teacher = _stage2_setup(seed)
    if kind == "compact_ft":
        tree, meta = jcft.compact_train_tree(np_tree(params), np_tree(masks),
                                             JCFG)
        fn = jcft.build_compact_stage2_step(JCFG, jhp, jthp, meta,
                                            donate=False)
    else:
        tree = params
        fn = jstep.build_stage2_step(JCFG, jhp, jthp, donate=False)
    x, y = _images(seed, steps)
    keys = [jax.random.PRNGKey(100 * seed + i) for i in range(steps)]

    def history():
        st = jstate.create_train_state(tree, jthp, None)
        hist = []
        for i, key in enumerate(keys):
            st, m = fn(st, teacher, masks, jnp.asarray(x[i]),
                       jnp.asarray(y[i]), key)
            hist.append((np_tree(m), np_tree(st.params), None))
        return hist

    noise = {str(i): {"mixup": _mix(jax.random.split(k)[0], jthp)}
             for i, k in enumerate(keys)}
    return (_settings(kind, hp), dict(params=params, teacher=teacher,
                                      masks=masks, x=x, labels=y,
                                      noise=noise), history)


BASE = dict(token_selection=True, token_number=0.75, ema_decay=0.9,
            drop_path_rate=0.1)


def _baseline_case(seed, steps):
    """The baseline step with drop-path and the Gumbel token top-k (its
    draws along the JAX step's key chain, as
    ``test_torch_port_run_baseline.py`` draws them)."""
    jthp = _jthp(mixup=0.0, cutmix=0.0)
    params = _params(seed)
    fn = jfinetune.build_baseline_step(JCFG, jthp, donate=False, **BASE)
    x, y = _images(seed, steps)
    keys = [jax.random.PRNGKey(100 * seed + i) for i in range(steps)]

    def history():
        st = jfinetune.create_baseline_state(params, jthp, BASE["ema_decay"])
        hist = []
        for i, key in enumerate(keys):
            st, m = fn(st, None, None, jnp.asarray(x[i]), jnp.asarray(y[i]),
                       key, jnp.float32(TAU))
            hist.append((np_tree(m), np_tree(st.params), None))
        return hist

    noise = {}
    rates = jnp.linspace(0.0, BASE["drop_path_rate"], JCFG.depth)
    for i, key in enumerate(keys):
        _, k_tok, _ = jax.random.split(key, 3)
        layer_keys = jax.random.split(jax.random.fold_in(k_tok, 7),
                                      JCFG.depth)
        keep = np.zeros((JCFG.depth, 2, GLOBAL), bool)
        for li in range(JCFG.depth):
            p = 1.0 - rates[li].astype(jnp.float32)
            for j in range(2):
                keep[li, j] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(layer_keys[li], j), p,
                    (GLOBAL, 1, 1)))[:, 0, 0]
        noise[str(i)] = dict(token=np.asarray(jax.random.gumbel(
            k_tok, (GLOBAL, JCFG.num_patches), jnp.float32)), drop_path=keep)
    settings = _settings("baseline", mixup=0.0, cutmix=0.0)
    settings["baseline"] = BASE
    return settings, dict(params=params, x=x, labels=y, noise=noise), history


def _port_draws_case(mode, steps=2, **thp):
    """Stage 1 with the port's own draws (``noise_seed``) and mixup in
    ``mode``; per sample, the partners lie on the other rank."""
    params = _params(5)
    x, y = _images(5, steps)
    settings = _settings("stage1", HP1, mixup_mode=mode, **thp)
    settings["noise_seed"] = 17
    return settings, dict(params=params, x=x, labels=y), None


def _eval_case():
    """No step: the eval totals of 13 images in batches of 4, a shard of 7
    a rank padded with label -1."""
    params = _params(6)
    rng = np.random.default_rng(6)
    settings = _settings("stage1", HP1)
    settings["eval_batch"] = 4
    return settings, dict(
        params=params, x=np.zeros((0, GLOBAL, 32, 32, 3), np.float32),
        labels=np.zeros((0, GLOBAL), np.int32),
        eval_x=rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8),
        eval_labels=rng.integers(0, 7, 13).astype(np.int32)), None


CASES = {
    "stage1": lambda: _stage1_case(1, 3, warmup=1),
    "accum": lambda: _port_draws_case("batch", steps=4, accum_steps=2),
    "stage2": lambda: _stage2_case("stage2", 3, 2),
    "compact_ft": lambda: _stage2_case("compact_ft", 4, 2),
    "baseline": lambda: _baseline_case(7, 2),
    "mixup_elem": lambda: _port_draws_case("elem"),
    "mixup_pair": lambda: _port_draws_case("pair"),
    "eval": _eval_case,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's spec run by two gloo ranks in one launch: per case
    (settings, arrays, JAX's history, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("ddp")
    cases, paths = {}, []
    for name, make in CASES.items():
        settings, trees, history = make()
        path = str(tmp / f"{name}.npz")
        dryrun.write_spec(path, settings, **trees)
        cases[name] = (settings, trees, history)
        paths.append(path)
    ranks = dryrun.launch_ranks(WORLD, device="cpu", tasks=paths, threads=1,
                                timeout=300, wait=False)
    # JAX's steps run while the ranks do
    cases = {name: (settings, trees, history and history())
             for name, (settings, trees, history) in cases.items()}
    ranks.wait()
    return {name: cases[name] + (dryrun.read_rank_results(p, WORLD), p)
            for name, p in zip(CASES, paths)}


def _same_bytes(ranks):
    """After every full step the ranks hold the same bytes (a micro-step
    keeps its rank's own gradient in the accumulation buffer)."""
    (r0, _), (r1, _) = ranks
    full = [i for i, m in enumerate(r0["metrics"]) if "grad_norm" in m]
    assert full and [r0["digests"][i] for i in full] == \
        [r1["digests"][i] for i in full]


def _rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def _compare(arrays, prefix, ref_tree, tol, key_bias=None):
    ref = _flat(ref_tree, prefix)
    got = {k: v for k, v in arrays.items() if k.startswith(prefix + "/")}
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        leaf = got[key].astype(np.float64)
        r = np.asarray(r, np.float64)
        assert leaf.shape == r.shape, key
        if key_bias is not None and key.endswith("token_scorer/bias"):
            # the top-k ignores a shift shared by every token's score
            np.testing.assert_allclose(leaf, r, atol=key_bias, rtol=0,
                                       err_msg=key)
            continue
        if key_bias is not None and key.endswith("qkv/bias"):
            third = leaf.shape[-1] // 3
            mid = slice(third, 2 * third)
            np.testing.assert_allclose(leaf[..., mid], r[..., mid],
                                       atol=key_bias, rtol=0, err_msg=key)
            leaf, r = (np.concatenate([a[..., :third], a[..., 2 * third:]],
                                      axis=-1) for a in (leaf, r))
        if np.any(r):
            assert _rel_fro(leaf, r) <= tol, (key, _rel_fro(leaf, r))
        else:
            np.testing.assert_allclose(leaf, r, atol=tol, err_msg=key)


def _against_jax(case, full_steps):
    settings, _, hist, ranks, _ = case
    _same_bytes(ranks)
    res, arrays = ranks[0]
    full = [i for i, m in enumerate(res["metrics"]) if "grad_norm" in m]
    assert len(full) == full_steps
    for i in full:
        jm = hist[i][0]
        for k, v in res["metrics"][i].items():
            np.testing.assert_allclose(v, np.asarray(jm[k], np.float64),
                                       rtol=TOL, atol=1e-6, err_msg=k)
    _, jparams, jcstate = hist[-1]
    _compare(arrays, "params", jparams, TOL, key_bias=LR * full_steps)
    if jcstate is not None:
        for f in ("s", "r", "y", "p", "z", "gating_accum"):
            np.testing.assert_allclose(arrays[f"cstate/{f}"],
                                       np.asarray(getattr(jcstate, f)),
                                       rtol=STATE_TOL, atol=STATE_TOL,
                                       err_msg=f)


def test_stage1_two_ranks_match_jax(runs):
    """A warmup and two UVC steps at bench.py's flagship settings cut to
    size (Gumbel block gating, Gumbel token top-k, batch mixup / cutmix
    against the flipped global batch): every step's metrics, the weights
    and the minimax state against JAX's single-process step."""
    _against_jax(runs["stage1"], 3)
    res = runs["stage1"][3][0][0]
    # the gating SGD step fires at step 2 (interval 2): s / r moved
    assert any(abs(v) > 0 for v in runs["stage1"][3][0][1]["cstate/s"]
               .ravel())
    assert res["reduce"]["calls"] == 3


@pytest.mark.parametrize("kind", ["stage2", "compact_ft"])
def test_stage2_paths_two_ranks_match_jax(runs, kind):
    """Two dense or compact stage-2 steps with the token drop and batch
    mixup / cutmix."""
    _against_jax(runs[kind], 2)


def test_baseline_two_ranks_match_jax(runs):
    """Two baseline steps with drop-path ``[L, 2, B]`` and token noise
    ``[B, N]`` drawn for the global batch, EMA on."""
    _against_jax(runs["baseline"], 2)


def _against_one_process(case):
    """The ranks' run against the port's single-process run of the same
    spec on the concatenated batches."""
    _, _, _, ranks, path = case
    _same_bytes(ranks)
    ref, ref_arrays = dryrun.run_spec(*dryrun.read_npz(path), device="cpu")
    res, arrays = ranks[0]
    for got, want in zip(res["metrics"], ref["metrics"]):
        assert set(got) == set(want)
        if "grad_norm" not in want:
            continue        # a micro-step's loss is its rank's own
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=1e-6,
                                       err_msg=k)
    steps = sum("grad_norm" in m for m in ref["metrics"])
    _compare(arrays, "params", _subtree_np(ref_arrays, "params"), TOL,
             key_bias=LR * steps)
    return res


def test_accumulation_across_ranks(runs):
    """Micro, full, micro, full: the micro-steps do not reduce (each rank
    keeps its own gradient), the full steps reduce the folded gradient
    once; the result is the single-process run's (whose accumulation
    ``test_torch_port_train.py`` holds against JAX's)."""
    res = _against_one_process(runs["accum"])
    assert res["reduce"]["calls"] == 2


@pytest.mark.parametrize("mode", ["elem", "pair"])
def test_mixup_partners_are_the_global_flip(runs, mode):
    """Per-sample mixup drawn by the port for the global batch: the two
    ranks' run equals the port's single-process run on the concatenated
    batch."""
    _against_one_process(runs[f"mixup_{mode}"])


def test_eval_totals_skip_the_padding(runs):
    """13 images over two ranks: each rank's shard of 7 is padded with a
    label -1 row, which is not counted; the totals match one process's."""
    _, _, _, ranks, path = runs["eval"]
    ref, _ = dryrun.run_spec(*dryrun.read_npz(path), device="cpu")
    for res, _ in ranks:
        correct, loss_sum, count = res["eval"]
        assert count == ref["eval"][2] == 13
        assert correct == ref["eval"][0]
        np.testing.assert_allclose(loss_sum, ref["eval"][1], rtol=1e-5)


def test_stage2_world_batch_scales_the_lr_as_jax(monkeypatch):
    """``run_stage2``'s default world batch is the loader's batch times the
    ranks, JAX's ``batch_size * process_count``: the lr each builds its
    step with is the same at two processes."""
    class Built(Exception):
        pass

    def grab(cfg, hp, thp, *a, **kw):
        raise Built(thp.learning_rate)

    loader = tpipe.SyntheticLoader(4, num_batches=1, img_size=32,
                                   num_classes=7)
    params, masks, _ = _stage2_setup(0)
    monkeypatch.setattr(jstage2, "build_stage2_step", grab)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(Built) as jerr:
        jstage2.run_stage2(JCFG, JHParams(), _jthp(), params=params,
                           masks=masks, train_loader=loader, test_loader=None,
                           save_checkpoints=False)
    monkeypatch.setattr(tstep, "build_stage2_step", grab)
    with pytest.raises(Built) as terr:
        tstage2.run_stage2(
            TCFG,
            THParams(), tstate.TrainHParams(**THP),
            params=params_from_numpy(np_tree(params), device="cpu"),
            masks=masks_from_numpy(np_tree(masks), device="cpu"),
            train_loader=loader, test_loader=None, save_checkpoints=False,
            mesh=pmesh.Mesh(size=2, rank=0), device="cpu")
    assert terr.value.args[0] == pytest.approx(jerr.value.args[0], rel=1e-12)
    assert terr.value.args[0] == pytest.approx(LR * 4 * 2 / 512.0)


def _subtree_np(arrays, prefix):
    return dryrun._subtree(arrays, prefix)




# ---------------------------------------------------------------------------
# the CLIs across two ranks
# ---------------------------------------------------------------------------

CLI = ["--model_type", "testing", "--dataset", "procedural",
       "--img_size", "32", "--train_batch_size", "8",
       "--eval_batch_size", "8", "--synthetic_steps", "3", "--device", "cpu"]
JOINT = CLI + ["--num_epochs", "2", "--warmup_epochs", "1",
               "--post_num_epochs", "1", "--warmup_steps", "2",
               "--enable_patch_gating", "2", "--patch_ratio", "0.7",
               "--distillation-type", "soft", "--name", "run"]
STAGE1 = ("run/testing_1.ckpt", "run/testing_2.ckpt",
          "run/testing_post_0.ckpt")


def _cli(tmp, name, module, argv, how, extra=()):
    """Start a CLI as two ranks, each with its own output directory
    (``<tmp>/<name>/r<rank>``), joined ``how``: by ``--coordinator`` /
    ``--num_processes`` / ``--process_id``, by torchrun's environment, or
    through ``cli/slurm_launch.py`` from a SLURM step's."""
    port = dryrun.free_port()

    def argv_of(r):
        out = list(argv) + ["--output_dir", str(tmp / name / f"r{r}")]
        if how == "coordinator":
            out += ["--coordinator", f"127.0.0.1:{port}",
                    "--num_processes", "2", "--process_id", str(r)]
        return out + list(extra)

    def env_of(r):
        env = {"OMP_NUM_THREADS": "1"}
        if how == "torchrun":
            env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        elif how == "slurm":
            env.update(SLURM_PROCID=str(r), SLURM_NTASKS="2",
                       SLURM_LOCALID=str(r), SLURM_STEP_NODELIST="127.0.0.1",
                       UVC_COORDINATOR_PORT=str(port))
        return env

    if how == "slurm":
        argv_of0 = argv_of
        stage2 = module.endswith("post_train")
        module = "uvc_tpu_torch.cli.slurm_launch"

        def argv_of(r):
            return (["--stage2"] if stage2 else []) + argv_of0(r)
    return dryrun.start_ranks(2, argv_of, module=module, env_for=env_of,
                              timeout=300)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """joint_train started each way, a 2-rank resume from the first run's
    epoch-1 checkpoint, post_train (through slurm_launch --stage2) and
    baseline_train: the directory of each."""
    tmp = tmp_path_factory.mktemp("cli")
    joint = "uvc_tpu_torch.cli.joint_train"
    _cli(tmp, "coordinator", joint, JOINT, "coordinator").wait()
    first = tmp / "coordinator" / "r0"
    started = [
        _cli(tmp, "torchrun", joint, JOINT, "torchrun"),
        _cli(tmp, "slurm", joint, JOINT, "slurm"),
        _cli(tmp, "resume", joint, JOINT, "coordinator",
             ["--resume", str(first / STAGE1[0])]),
        _cli(tmp, "post", "uvc_tpu_torch.cli.post_train",
             CLI + ["--num_epochs", "1", "--enable_patch_gating", "2",
                    "--patch_ratio", "0.7", "--name", "s2",
                    "--checkpoint_dir", str(first / STAGE1[1])], "slurm"),
        _cli(tmp, "baseline", "uvc_tpu_torch.cli.baseline_train",
             CLI + ["--epochs", "1", "--model_ema", "1", "--name", "base"],
             "torchrun")]
    for ranks in started:
        ranks.wait()
    return tmp


def _ckpts(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*.ckpt")) \
        if d.exists() else []


@pytest.mark.parametrize("how", ["coordinator", "torchrun", "slurm"])
def test_joint_train_across_two_ranks(cli_runs, how):
    """Stage 1 and the inline stage 2 through joint_train, however the
    ranks are joined: rank 0 alone writes the checkpoints (rank 1's
    output directory stays empty), and the three ways give the same
    bytes."""
    r0, r1 = cli_runs / how / "r0", cli_runs / how / "r1"
    assert _ckpts(r0) == sorted(STAGE1)
    assert _ckpts(r1) == []
    assert (r0 / "run" / "metrics.jsonl").exists()
    first = cli_runs / "coordinator" / "r0"
    for f in STAGE1:
        assert (r0 / f).read_bytes() == (first / f).read_bytes(), f
    ck = load_checkpoint(str(r0 / STAGE1[1]))
    assert int(ck["global_step"]) == 6 and int(ck["epoch"]) == 2


def test_joint_train_resume_across_two_ranks(cli_runs):
    """A 2-rank --resume from the epoch-1 checkpoint repeats the
    uninterrupted run's epoch 2 and stage 2 bit for bit."""
    first, again = cli_runs / "coordinator" / "r0", cli_runs / "resume" / "r0"
    for f in STAGE1[1:]:
        assert (again / f).read_bytes() == (first / f).read_bytes(), f
    assert _ckpts(cli_runs / "resume" / "r1") == []


@pytest.mark.parametrize("run,want", [
    ("post", ["s2/testing_post_0.ckpt"]),
    ("baseline", ["base/testing_baseline_0.ckpt"])])
def test_stage2_and_baseline_clis_across_two_ranks(cli_runs, run, want):
    """post_train (started by slurm_launch --stage2) and baseline_train
    (by torchrun's environment) across two ranks: rank 0 writes."""
    assert _ckpts(cli_runs / run / "r0") == want
    assert _ckpts(cli_runs / run / "r1") == []


def test_dryrun_multiprocess_prints_ok(capsys):
    dryrun.dryrun_multiprocess(2, "cpu", timeout=300)
    out = capsys.readouterr().out
    for stage in ("stage1", "stage2", "compact_ft"):
        assert f"dryrun_multiprocess(2) {stage} ok: mesh=(2 dp x 1 mp)" in out
    assert "dryrun_multiprocess(2) ok: stage1+stage2+compact_ft on " \
        "(2 dp x 1 mp)" in out


# ---------------------------------------------------------------------------
# the mesh in one process
# ---------------------------------------------------------------------------


def test_initialize_multihost_refuses_at_once(monkeypatch):
    """More than one process with no coordinator and no torchrun
    environment raises ValueError before any rendezvous; one process is
    a no-op."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--coordinator"):
        pmesh.initialize_multihost(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="--process_id"):
        pmesh.initialize_multihost("127.0.0.1:1", 2, None, device="cpu")
    pmesh.initialize_multihost(None, 1, 0, device="cpu")
    pmesh.initialize_multihost(None, None, None, device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_checks_as_jax():
    """One process: a mesh of one rank; dp * mp other than the world size
    raises JAX's ValueError, with a model axis too (``dp`` defaulting to
    the world size over ``mp``, 0 here)."""
    m = pmesh.make_mesh()
    assert (m.size, m.rank, m.shape) == (1, 0, {"data": 1, "model": 1})
    with pytest.raises(ValueError,
                       match=r"dp\(2\) \* mp\(1\) != device count \(1\)"):
        pmesh.make_mesh(dp=2)
    with pytest.raises(ValueError,
                       match=r"dp\(1\) \* mp\(2\) != device count \(1\)"):
        pmesh.make_mesh(dp=1, mp=2)
    with pytest.raises(ValueError,
                       match=r"dp\(0\) \* mp\(2\) != device count \(1\)"):
        pmesh.make_mesh(mp=2)


def test_shard_batch_rows_and_message():
    """Rank r keeps the r-th of W equal runs of rows (along any axis); a
    batch the ranks do not divide raises JAX's message."""
    x = torch.arange(24).reshape(6, 4)
    a, b = pmesh.shard_batch((x, x + 1), pmesh.Mesh(size=3, rank=1))
    assert torch.equal(a, x[2:4]) and torch.equal(b, x[2:4] + 1)
    c = pmesh.shard_batch(x, pmesh.Mesh(size=2, rank=1), axis=1)
    assert torch.equal(c, x[:, 2:])
    with pytest.raises(ValueError, match="data-parallel mesh size 4; pick "
                                         "--train_batch_size"):
        pmesh.shard_batch(x, pmesh.Mesh(size=4, rank=0))


@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
def test_shard_noise_keeps_the_rows_of_the_global_draw(mode):
    """Each rank's rows of the token noise, drop-path, erasing and the
    per-sample mixup decisions (in pair mode each row's pair's), the
    ``[L, 2]`` draws whole."""
    from uvc_tpu_torch.baselines.finetune import draw_baseline_noise
    thp = tstate.TrainHParams(mixup_mode=mode, num_classes=7)
    noise = draw_baseline_noise(torch.Generator().manual_seed(3), TCFG, thp,
                                8, token_selection=True, drop_path_rate=0.1,
                                re_prob=0.5, device="cpu")
    parts = [tstep.shard_noise(noise, thp, pmesh.Mesh(size=2, rank=r))
             for r in range(2)]
    assert torch.equal(torch.cat([p.token for p in parts]), noise.token)
    assert torch.equal(torch.cat([p.drop_path for p in parts], dim=2),
                       noise.drop_path)
    assert torch.equal(torch.cat([p.erasing.fill for p in parts], dim=1),
                       noise.erasing.fill)
    rows = torch.arange(8)
    if mode == "pair":
        rows = torch.minimum(rows, 7 - rows)
    for field in ("lam", "use_blend", "box"):
        got = torch.cat([getattr(p.mixup, field) for p in parts]) \
            if mode != "batch" else getattr(parts[1].mixup, field)
        want = getattr(noise.mixup, field)
        assert torch.equal(got, want[rows] if mode != "batch" else want)
    assert tstep.shard_noise(noise, thp, None) is noise


def test_mixup_with_partners_is_the_local_flip_in_one_process():
    """``mixup_cutmix`` given the flipped batch as partners (and the draw's
    rows in pair mode) mixes exactly as the flip does."""
    from uvc_tpu_torch.data.mixup import mixup_cutmix, sample_mixup
    x = torch.randn(6, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    y = torch.arange(6) % 7
    for mode in ("batch", "elem", "pair"):
        draw = sample_mixup(torch.Generator().manual_seed(1), 32, 32,
                            decisions=None if mode == "batch" else 6)
        want = mixup_cutmix(x, y, draw, num_classes=7, mode=mode)
        got = mixup_cutmix(x, y, rows_of_draw(draw, mode, torch.arange(6)),
                           num_classes=7, mode=mode,
                           partner=pmesh.flip_partners(x, y, None))
        for a, b in zip(got, want):
            assert torch.equal(a, b), mode


def test_reduce_and_replicate_are_the_identity_without_a_group():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
    mesh = pmesh.Mesh(size=1, rank=0)
    assert pmesh.replicate(tree, mesh) is tree
    out, loss = pmesh.all_reduce_mean(tree, mesh, torch.tensor(2.0))
    assert out is tree and float(loss) == 2.0
    assert pmesh.sum_across([1, 2.5], mesh) == [1.0, 2.5]


def test_buckets_hold_runs_of_one_dtype_under_the_limit():
    """Consecutive leaves of one dtype, at most the limit each (a larger
    leaf alone), in order."""
    leaves = [torch.zeros(10), torch.zeros(10), torch.zeros(30),
              torch.zeros(5, dtype=torch.float64), torch.zeros(2)]
    assert pmesh._buckets(leaves, 100) == [[0, 1], [2], [3], [4]]
