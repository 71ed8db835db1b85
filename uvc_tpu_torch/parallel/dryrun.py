"""The multi-process dry run and its rank worker (the port's counterpart
of the JAX package's ``entry`` and ``dryrun_multichip`` in
``__graft_entry__.py``).

    python -m uvc_tpu_torch.parallel.dryrun --ranks 8 --device cpu

spawns eight ranks of this module, joined at a localhost port, on a mesh
of 4 dp x 2 mp by the JAX dry run's rule (``mp`` 2 where the count is
even and at least 4, else 1), each of which runs one step of stage 1,
stage 2 and compact_ft (its compact tree replicated) at tiny shapes
(``dryrun_multiprocess``).  A rank is

    python -m uvc_tpu_torch.parallel.dryrun --rank R --world N \\
        --init 127.0.0.1:PORT --device cpu [--mp M] [--task SPEC.npz ...]

and with ``--task`` it runs the steps each spec file describes
(``run_spec``: stage 1, stage 2, compact_ft or the baseline fine-tune,
from given or seeded weights, on given global batches, with given or
drawn noise) and writes what each step gave to ``SPEC.npz.rank<R>.npz``:
its metrics, a digest of the whole (gathered) state after it, its kernel
launches, and the whole state at the end.
``run_spec`` with no mesh is the single-process run of the same spec on
the whole global batch, the reference a data- or tensor-parallel run is
held to.
``launch_ranks`` starts the ranks for a Python caller (the tests and the
chip smoke run), which may ask for the gloo backend on the card: NCCL
takes one rank a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from uvc_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# torchrun's variables, which a spawned rank must not inherit
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "SLURM_LOCALID")


def entry(device="cuda"):
    """``(fn, args)``: DeiT-Small's eval forward (``vit.apply`` then
    ``eval_logits``, bf16) and its seeded parameters with a zero batch of
    8 on ``device``, as the JAX package's ``entry`` returns them."""
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.interop import resolve_device
    from uvc_tpu_torch.models import vit

    dev = resolve_device(device)
    cfg = get_config("deit_small_patch16_224")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)

    def fwd(params, x):
        out = vit.apply(params, x, cfg, dtype=torch.bfloat16, train=False)
        return vit.eval_logits(out, cfg)

    x = torch.zeros((8, cfg.img_size, cfg.img_size, cfg.in_chans),
                    dtype=torch.bfloat16, device=dev)
    return fwd, (params, x)


# ---------------------------------------------------------------------------
# spec files: nested trees as "a/b/c" keys of one .npz, settings as JSON
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu()
            tree = (tree.float() if tree.dtype == torch.bfloat16
                    else tree).numpy()
        out[prefix] = np.asarray(tree)


def _subtree(arrays: Dict[str, np.ndarray], prefix: str) -> Optional[dict]:
    """The nested dict of the keys under ``prefix/`` (None if none)."""
    tree: dict = {}
    head = prefix + "/"
    for key, value in arrays.items():
        if not key.startswith(head):
            continue
        node = tree
        parts = key[len(head):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree or None


def write_spec(path: str, settings: dict, **trees) -> None:
    """A spec file: ``settings`` (JSON) and each tree of ``trees``
    (params, teacher, masks, wmasks, x, labels, noise, eval_x, ...)."""
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        _flatten(tree, name, arrays)
    arrays["__settings__"] = np.array(json.dumps(settings))
    np.savez(path, **arrays)


def read_npz(path: str):
    """(settings or results JSON, the arrays by key) of a file written
    here."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(str(arrays.pop("__settings__"))), arrays


# ---------------------------------------------------------------------------
# one spec's steps
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _noise(kind: str, fields: Optional[dict], dev):
    """The global noise of one step from its arrays (None fields absent)."""
    from uvc_tpu_torch.baselines.finetune import BaselineNoise
    from uvc_tpu_torch.data.mixup import MixupDraw
    from uvc_tpu_torch.train.step import Stage1Noise, Stage2Noise

    cls = {"stage1": Stage1Noise, "baseline": BaselineNoise}.get(
        kind, Stage2Noise)
    fields = fields or {}
    out = {}
    for name in cls._fields:
        v = fields.get(name)
        if v is None:
            out[name] = None
        elif name == "mixup":
            out[name] = MixupDraw(*(torch.from_numpy(np.array(v[k])).to(dev)
                                    for k in ("lam", "use_blend", "box")))
        else:
            out[name] = torch.from_numpy(np.array(v)).to(dev)
    return cls(**out)


def _digest(obj) -> str:
    h = hashlib.sha256()
    for t in pmesh.tree_tensors(obj):
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _launches() -> dict:
    from uvc_tpu_torch.ops import backward_launch_counts, launch_counts
    return {k: v for k, v in {**launch_counts(),
                              **backward_launch_counts()}.items() if v}


def run_spec(settings: dict, arrays: Dict[str, np.ndarray],
             mesh: Optional[pmesh.Mesh] = None, device="cuda",
             mp: int = 1) -> tuple:
    """Run the steps of a spec on ``device``: with a ``mesh``, as one rank
    of a data-parallel run (the rows of its data index of each global
    batch and noise) and, with ``mp > 1`` (the mesh's model axis), of a
    tensor-parallel one (its shard of the state and the teacher), else on
    the whole global batch.  Returns ``(results, state arrays)``: per
    step the metrics, a digest of the whole state after it, its time and,
    on the card, its kernel launches; the all-reduce's clock and the
    steps' all-gathers' (not the digests'); under ``mp > 1`` the bytes this rank holds of
    the tensor-parallel leaves of the params and their whole bytes; the
    eval totals; and, with ``return_state``, the whole state at the end.

    The settings: ``kind`` (stage1, stage2, compact_ft, baseline),
    ``model`` and ``cfg`` (its overrides), ``hp``, ``thp`` (its
    ``compute_dtype`` "float32" or "bfloat16"), ``seed`` and ``head_std``
    (seeded weights, random heads, where the arrays hold no ``params`` /
    ``teacher``), ``data`` ([steps, global batch, seed]: seeded images
    and labels in place of the arrays ``x`` / ``labels``), ``noise_seed``
    (each step's noise drawn as the drivers draw it, where the arrays hold
    no ``noise/<step>``), ``tau``, ``warmup`` (stage 1's first warmup
    steps), ``baseline`` (the baseline step's settings), ``eval_batch``
    (with the arrays ``eval_x`` / ``eval_labels``), ``return_state`` and
    ``step_states`` (the whole params after every step, as
    ``step<i>/params``, from rank 0 only)."""
    from uvc_tpu_torch.baselines import finetune
    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.interop import (masks_from_numpy, params_from_numpy,
                                       resolve_device, wmasks_from_numpy)
    from uvc_tpu_torch.models import get_model
    from uvc_tpu_torch.ops import reset_launch_counts
    from uvc_tpu_torch.train import step as tstep
    from uvc_tpu_torch.train.compact_ft import (build_compact_stage2_step,
                                                compact_train_tree)
    from uvc_tpu_torch.train.stage1 import eval_fn_for, eval_totals
    from uvc_tpu_torch.train.state import (TrainHParams, create_train_state,
                                           gather_state, shard_state)

    pmesh.check_model_axis(mesh, mp)
    dev = resolve_device(device)
    kind = settings["kind"]
    cfg = get_config(settings["model"]).replace(**settings.get("cfg", {}))
    hp = MinimaxHParams(**settings.get("hp", {}))
    tf = dict(settings.get("thp", {}))
    tf["compute_dtype"] = _DTYPES[tf.get("compute_dtype", "bfloat16")]
    tf.setdefault("num_classes", cfg.num_classes)
    thp = TrainHParams(**tf)
    model = get_model(cfg)

    def weights(name, seed):
        tree = _subtree(arrays, name)
        if tree is not None:
            return params_from_numpy(tree, device=dev)
        gen = torch.Generator().manual_seed(seed)
        tree = model.init_params(gen, cfg, device=dev)
        if settings.get("head_std"):
            # zero-initialised heads give all-zero logits
            k = tree["head"]["kernel"]
            tree["head"]["kernel"] = settings["head_std"] * torch.randn(
                k.shape, generator=gen).to(dev)
        return tree

    params = weights("params", settings.get("seed", 0))
    teacher = weights("teacher", settings.get("seed", 0) + 1)
    masks = masks_from_numpy(_subtree(arrays, "masks"), device=dev)
    wmasks = wmasks_from_numpy(_subtree(arrays, "wmasks"), device=dev)
    if mesh is not None:
        params, teacher, masks, wmasks = pmesh.replicate(
            (params, teacher, masks, wmasks), mesh)
    world = 1 if mesh is None else mesh.dp
    if "data" in settings:
        # [steps, global batch] images and labels drawn from a seed
        steps_, batch_, seed_ = settings["data"]
        gen = torch.Generator().manual_seed(seed_)
        x_all = torch.randn((steps_, batch_, cfg.img_size, cfg.img_size,
                             cfg.in_chans), generator=gen).numpy()
        y_all = torch.randint(0, cfg.num_classes, (steps_, batch_),
                              generator=gen).numpy()
    else:
        x_all, y_all = arrays["x"], arrays["labels"]
    n_steps, global_batch = x_all.shape[0], x_all.shape[1]
    noise_arrays = _subtree(arrays, "noise") or {}
    gen = torch.Generator().manual_seed(settings.get("noise_seed", 0))
    tau = settings.get("tau", -1.0)
    accum = thp.accum_steps
    base = settings.get("baseline", {})

    if kind == "stage1":
        table = build_macs_table(cfg)
        state = create_train_state(params, thp,
                                   init_compression_state(cfg, hp, dev))
        steps = {(w, m): tstep.build_stage1_step(
            cfg, table, hp, thp, warmup=w, micro=m, mesh=mesh)
            for w in (True, False) for m in (False, True)}

        def take(st, i, x, y, noise, micro):
            warm = i < settings.get("warmup", 0)
            return steps[(warm, micro)](st, teacher, x, y, noise, tau)

        def draw():
            return tstep.draw_stage1_noise(gen, cfg, hp, thp, global_batch,
                                           dev)
    elif kind in ("stage2", "compact_ft"):
        if kind == "compact_ft":
            ctree, meta = compact_train_tree(params, masks, cfg)
            state = create_train_state(ctree, thp, None)
            steps = {m: build_compact_stage2_step(cfg, hp, thp, meta,
                                                  micro=m, mesh=mesh)
                     for m in (False, True)}
        else:
            state = create_train_state(params, thp, None)
            steps = {m: tstep.build_stage2_step(cfg, hp, thp, micro=m,
                                                mesh=mesh)
                     for m in (False, True)}

        def take(st, i, x, y, noise, micro):
            return steps[micro](st, teacher, masks, x, y, noise)

        def draw():
            return tstep.draw_stage2_noise(gen, cfg, thp, global_batch, dev)
    elif kind == "baseline":
        state = finetune.create_baseline_state(
            params, thp, base.get("ema_decay", 0.0))
        keys = ("token_selection", "drop_path_rate", "re_prob")
        step_fn = finetune.build_baseline_step(
            cfg, thp, token_number=base.get("token_number", 0.7),
            ema_decay=base.get("ema_decay", 0.0), mesh=mesh,
            **{k: base[k] for k in keys if k in base})
        draw_keys = keys + ("re_count", "re_mode")

        def take(st, i, x, y, noise, micro):
            return step_fn(st, teacher if base.get("distill") else None,
                           wmasks, x, y, noise, tau)

        def draw():
            return finetune.draw_baseline_noise(
                gen, cfg, thp, global_batch, device=dev,
                **{k: base[k] for k in draw_keys if k in base})
    else:
        raise ValueError(f"unknown spec kind {kind!r}")
    state = shard_state(state, mesh, mp)
    teacher = pmesh.shard_params(teacher, mesh, mp)

    on_card = dev.type == "cuda"
    tensors: Dict[str, np.ndarray] = {}
    gathered: List[dict] = []
    pmesh.reset_reduce_clock(events=on_card)
    out: Dict[str, Any] = {"metrics": [], "digests": [], "launches": [],
                           "step_ms": []}
    for i in range(n_steps):
        x = torch.from_numpy(x_all[i])
        y = torch.from_numpy(y_all[i]).long()
        if mesh is not None:
            x, y = pmesh.shard_batch((x, y), mesh)
        x, y = x.to(dev), y.to(dev)
        fields = noise_arrays.get(str(i))
        noise = _noise(kind, fields, dev) if fields is not None or \
            "noise_seed" not in settings else draw()
        noise = tstep.shard_noise(noise, thp, mesh)
        micro = accum > 1 and (i + 1) % accum != 0
        if on_card:
            torch.cuda.synchronize()
            reset_launch_counts()
        before = pmesh.gather_clock()
        t0 = time.perf_counter()
        state, m = take(state, i, x, y, noise, micro)
        if on_card:
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        # the step's own all-gathers (the digest below gathers too)
        after = pmesh.gather_clock()
        gathered.append({k: (after[k] or 0) - (before[k] or 0)
                         for k in after})
        if on_card:
            out["launches"].append(_launches())
        out["metrics"].append({k: float(v) for k, v in m.items()})
        now = gather_state(state, mesh)
        out["digests"].append(_digest(now))
        if settings.get("step_states") and (mesh is None or mesh.rank == 0):
            _flatten(now.params, f"step{i}/params", tensors)
    out["reduce"] = pmesh.reduce_clock()
    out["gather"] = {k: sum(g[k] for g in gathered)
                     for k in ("calls", "host_ms", "device_ms")}
    local = pmesh.tensor_parallel_leaves(state.params, mp)
    state = gather_state(state, mesh)
    if mp > 1:
        out["tp_bytes"] = [
            sum(t.untyped_storage().nbytes() for t in local),
            sum(t.numel() * t.element_size() for t in
                pmesh.tensor_parallel_leaves(state.params, mp))]
    if settings.get("return_state"):
        _flatten(state.params, "params", tensors)
        _flatten(pmesh.tree_tensors(state.opt_state), "opt", tensors)
        _flatten(getattr(state, "ema_params", None), "ema", tensors)
        if getattr(state, "cstate", None) is not None:
            _flatten({f.name: getattr(state.cstate, f.name)
                      for f in dataclasses.fields(state.cstate)
                      if torch.is_tensor(getattr(state.cstate, f.name))},
                     "cstate", tensors)
    if "eval_x" in arrays:
        from uvc_tpu_torch.data.pipeline import ArrayLoader
        loader = ArrayLoader(arrays["eval_x"], arrays["eval_labels"],
                             settings["eval_batch"], train=False,
                             img_size=cfg.img_size,
                             pid=0 if mesh is None else mesh.data_index,
                             pcount=world)
        ev_params = params if kind == "compact_ft" else state.params
        if kind == "baseline":
            fn = finetune.build_baseline_eval_step(cfg, thp)
            out["eval"] = list(eval_totals(fn, ev_params, wmasks, loader,
                                           dev, mesh))
        else:
            fn = eval_fn_for(cfg, hp, thp, masked=masks is not None)
            out["eval"] = list(eval_totals(fn, ev_params, masks, loader,
                                           dev, mesh))
    return out, tensors


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """Rank processes started by ``start_ranks``; ``wait`` returns their
    outputs."""

    def __init__(self, procs, timeout: float):
        self.procs, self.timeout = procs, timeout
        self.deadline = time.monotonic() + timeout

    def wait(self) -> List[str]:
        """The ranks' outputs once all have exited; a rank that fails or
        outlives the timeout raises RuntimeError, every rank stopped."""
        outs = []
        try:
            for p in self.procs:
                left = max(1.0, self.deadline - time.monotonic())
                outs.append(p.communicate(timeout=left)[0].decode(
                    errors="replace"))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"a rank outlived {self.timeout} s")
        for r, (p, text) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   f"{text[-6000:]}")
        return outs


def start_ranks(world: int, argv: Sequence[str], *,
                module: str = "uvc_tpu_torch.parallel.dryrun",
                env_for=None, timeout: float = 600.0) -> Ranks:
    """Start ``world`` processes of ``python -m module argv(rank)`` from
    the repository's root (``argv`` a list, or a function of the rank;
    ``env_for(rank)`` adds variables), none inheriting torchrun's."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for r in range(world):
        args = list(argv(r) if callable(argv) else argv)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + args, cwd=REPO,
            env=dict(env, **(env_for(r) if env_for else {})),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return Ranks(procs, timeout)


def launch_ranks(world: int, *, device="cuda", backend: Optional[str] = None,
                 tasks: Sequence[str] = (), threads: int = 2,
                 timeout: float = 600.0, wait: bool = True, mp: int = 1):
    """Run ``world`` ranks of this module joined at a free localhost port
    on a ``world / mp x mp`` mesh and return their outputs (``wait=False``:
    the started ``Ranks``).  ``tasks``: spec files, run in order, each rank
    writing ``<spec>.rank<r>.npz`` (``read_rank_results``); none: the tiny
    dry run."""
    port = free_port()

    def argv(r):
        cmd = ["--rank", str(r), "--world", str(world),
               "--init", f"127.0.0.1:{port}", "--device", str(device),
               "--threads", str(threads), "--timeout", str(int(timeout)),
               "--mp", str(mp)]
        if backend:
            cmd += ["--backend", backend]
        for task in tasks:
            cmd += ["--task", task]
        return cmd

    ranks = start_ranks(world, argv, timeout=timeout)
    return ranks.wait() if wait else ranks


def read_rank_results(task: str, world: int) -> list:
    """Each rank's ``(results, arrays)`` of the spec file ``task``."""
    return [read_npz(f"{task}.rank{r}.npz") for r in range(world)]


def _dryrun_specs(world: int) -> list:
    """The tiny dry run's three specs (the JAX dry run's shapes: DeiT-Small
    cut to 32 px, depth 2 and 16 classes; zero batches of 2 a rank; stage
    2 and compact_ft on one head and half the MLP pruned in block 0)."""
    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import vit

    cut = dict(img_size=32, depth=2, num_classes=16)
    cfg = get_config("deit_small_patch16_224").replace(**cut)
    batch = world * 2
    x = np.zeros((1, batch, 32, 32, 3), np.float32)
    y = np.zeros((1, batch), np.int32)
    common = dict(model="deit_small_patch16_224", cfg=cut, tau=5.0,
                  noise_seed=0,
                  hp=dict(gating_interval=2, enable_patch_gating=2,
                          patch_ratio=0.9),
                  thp=dict(num_classes=16, t_total=100, warmup_steps=2,
                           compute_dtype="bfloat16"))
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    s = torch.tensor([[1.0, cfg.mlp_hidden // 2]] + [[0.0, 0.0]]
                     * (cfg.depth - 1))
    r = torch.zeros(cfg.depth, cfg.num_heads)
    masks = build_masks(params, s, r, cfg)
    return [(dict(common, kind="stage1"), dict(params=params, x=x, labels=y)),
            (dict(common, kind="stage2"), dict(params=params, masks=masks,
                                               x=x, labels=y)),
            (dict(common, kind="compact_ft"),
             dict(params=params, masks=masks, x=x, labels=y))]


def dryrun_model_axis(n: int) -> int:
    """The JAX dry run's model axis for ``n`` devices: 2 where ``n`` is
    even and at least 4, else 1."""
    return 2 if n % 2 == 0 and n >= 4 else 1


def _dryrun_rank(mesh: pmesh.Mesh, device) -> None:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for settings, trees in _dryrun_specs(mesh.size):
            path = os.path.join(tmp, settings["kind"] + ".npz")
            write_spec(path, settings, **trees)
            res, _ = run_spec(*read_npz(path), mesh=mesh, device=device,
                              mp=mesh.mp)
            m = res["metrics"][0]
            if not np.isfinite(m["loss"]):
                raise RuntimeError(f"{settings['kind']}: loss {m['loss']}")
            if mesh.rank == 0:
                extra = (f" resource={m['resource']:.4f}"
                         if "resource" in m else "")
                print(f"dryrun_multiprocess({mesh.size}) {settings['kind']} "
                      f"ok: mesh=({mesh.dp} dp x {mesh.mp} mp) "
                      f"loss={m['loss']:.4f}{extra}", flush=True)


def dryrun_multiprocess(n: int, device="cuda",
                        backend: Optional[str] = None,
                        timeout: float = 600.0) -> None:
    """Spawn ``n`` ranks on a mesh of ``n / mp x mp`` (``mp`` by the JAX
    dry run's rule, ``dryrun_model_axis``), each running one step of
    stage 1 (the minimax update included), stage 2 and compact_ft at tiny
    shapes on its share of the global batch and its shard of the weights;
    print their lines and ``dryrun_multiprocess(n) ok: ...``.  Raises if
    a rank fails."""
    mp = dryrun_model_axis(n)
    outs = launch_ranks(n, device=device, backend=backend, timeout=timeout,
                        mp=mp)
    print(outs[0], end="")
    print(f"dryrun_multiprocess({n}) ok: stage1+stage2+compact_ft on "
          f"({n // mp} dp x {mp} mp)", flush=True)


def _rank_main(args) -> int:
    torch.set_num_threads(args.threads)
    pmesh.initialize_multihost(
        args.init, args.world, args.rank, backend=args.backend,
        timeout=datetime.timedelta(seconds=args.timeout),
        device=args.device)
    try:
        mesh = pmesh.make_mesh(mp=args.mp)
        for task in args.task:
            settings, arrays = read_npz(task)
            res, tensors = run_spec(settings, arrays, mesh=mesh,
                                    device=args.device, mp=args.mp)
            tensors["__settings__"] = np.array(json.dumps(res))
            np.savez(f"{task}.rank{args.rank}.npz", **tensors)
        if not args.task:
            _dryrun_rank(mesh, args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks of the tiny dry run")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init", default=None, help="host:port of rank 0")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--mp", type=int, default=1,
                    help="a rank's tensor-parallel size")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--task", action="append", default=[],
                    help="a spec file (repeatable)")
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multiprocess(args.ranks or 2, args.device, args.backend,
                            args.timeout)
        return 0
    return _rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
