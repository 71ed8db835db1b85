"""SLURM multi-node launcher for the port's CLIs (counterpart of
``uvc_tpu/cli/slurm_launch.py``).

Maps the SLURM step environment onto the port's process group
(``parallel/mesh.py::initialize_multihost``): coordinator = first host of
the step nodelist, process_id = SLURM_PROCID, num_processes =
SLURM_NTASKS, and re-enters the normal CLI entry point
(``uvc_tpu_torch.cli.joint_train``, or ``post_train`` with ``--stage2``).
One task per GPU, not per host: ``#SBATCH --ntasks-per-node=<GPUs>``;
each task takes the card of its ``SLURM_LOCALID``.

Preemption/requeue: both trainers checkpoint every epoch and support
full mid-run resume, so on a requeued step we inject ``--resume <newest
ckpt of the stage being relaunched>`` (stage-1 ``<model>_<epoch>.ckpt`` /
stage-2 ``<model>_post_<epoch>.ckpt``) when the caller didn't pass one.

Usage (inside an sbatch allocation):

    srun python -m uvc_tpu_torch.cli.slurm_launch [--stage2] <joint_train args>
"""

import argparse
import os
import re
import sys
from typing import Dict, List, Optional

from uvc_tpu_torch.utils import yaml_config

DEFAULT_PORT = 12321


def _head(nodelist: str) -> str:
    """Text up to the first top-level comma (commas inside ``[...]``
    range groups don't split hosts)."""
    depth = 0
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            return nodelist[:i]
    return nodelist


def first_host(nodelist: str) -> str:
    """First hostname of a compact SLURM nodelist.

    Handles the common shapes without scontrol: ``host1,host2``,
    ``node[001-004]``, ``node[3,7-9]``, ``host1,node[3-4]``,
    ``tpu-[a,b]-host`` and plain single names.  (scontrol is preferred
    when available; this is the hermetic fallback so the derivation is
    unit-testable.)
    """
    head = _head(nodelist.strip())
    m = re.match(r"([^\[]*)\[([^\]]+)\](.*)", head)
    if not m:
        return head.strip()
    prefix, body, suffix = m.groups()
    first = re.split(r"[,\-]", body, 1)[0]
    # suffix may itself contain another bracket group (rare multi-dim
    # names); recurse.
    rest = first_host(suffix) if suffix else ""
    return prefix + first + rest


def derive_slurm_args(env: Dict[str, str]) -> Optional[Dict[str, object]]:
    """Map the SLURM step env to the process group's init args.

    Returns None outside SLURM (single-process run).  Honors explicit
    UVC_COORDINATOR[_PORT] overrides (e.g. when node names don't
    resolve across the hosts' network).
    """
    ntasks = int(env.get("SLURM_NTASKS", "1") or "1")
    if "SLURM_PROCID" not in env or ntasks <= 1:
        return None
    host = env.get("UVC_COORDINATOR")
    if not host:
        nodelist = (env.get("SLURM_STEP_NODELIST")
                    or env.get("SLURM_JOB_NODELIST", ""))
        host = first_host(nodelist) if nodelist else None
    if not host:
        return None
    port = int(env.get("UVC_COORDINATOR_PORT", str(DEFAULT_PORT)))
    coordinator = host if ":" in host else f"{host}:{port}"
    return {"coordinator": coordinator,
            "num_processes": ntasks,
            "process_id": int(env["SLURM_PROCID"])}


def find_resume_ckpt(output_dir: str, name: str,
                     stage2: bool = False) -> Optional[str]:
    """Newest resumable checkpoint under output_dir/name, for requeue.

    Stage-1 epoch ckpts are ``<model>_<epoch>.ckpt``; stage-2's are
    ``<model>_post_<epoch>.ckpt`` (both are full-resume trees, and both
    CLIs honor ``--resume``).  ``*_best.ckpt`` snapshots are excluded:
    they track best accuracy, not training progress.
    """
    run_dir = os.path.join(output_dir, name)
    if not os.path.isdir(run_dir):
        return None
    cands = [os.path.join(run_dir, f) for f in os.listdir(run_dir)
             if f.endswith(".ckpt") and "_best" not in f
             and ("_post_" in f) == stage2]
    return max(cands, key=os.path.getmtime) if cands else None


def _has_flag(argv: List[str], flag: str) -> bool:
    """True if argv carries ``flag`` in either ``--f v`` or ``--f=v``
    form (argparse is last-wins, so blind appending would silently
    override an explicit user value)."""
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def _probe_run_dir(argv: List[str]) -> tuple:
    """(output_dir, name) the trainers will actually use.

    Defaults must match cli/flags.py add_common_flags; a ``--config``
    YAML can also set them (flags.parse_with_config semantics: config
    overrides defaults, explicit CLI flags win over the config).
    """
    probe = argparse.ArgumentParser(add_help=False)
    probe.add_argument("-c", "--config", default=None)
    probe.add_argument("--output_dir", default="output/uvc_train")
    probe.add_argument("--name", default="debug")
    known, _ = probe.parse_known_args(argv)
    if known.config:
        try:
            overrides = yaml_config.load(known.config) or {}
        except (OSError, ValueError):
            # best-effort probe only (an unreadable file, YAML the reader
            # refuses): the trainer surfaces real config errors itself —
            # the launcher must never die here
            overrides = {}
        if not _has_flag(argv, "--output_dir") and "output_dir" in overrides:
            known.output_dir = overrides["output_dir"]
        if not _has_flag(argv, "--name") and "name" in overrides:
            known.name = overrides["name"]
    return known.output_dir, known.name


def build_argv(argv: List[str], env: Dict[str, str],
               stage2: bool = False) -> List[str]:
    """Inject --coordinator/--num_processes/--process_id and --resume."""
    out = list(argv)
    dist = derive_slurm_args(env)
    if dist and not _has_flag(out, "--coordinator"):
        out += ["--coordinator", str(dist["coordinator"]),
                "--num_processes", str(dist["num_processes"]),
                "--process_id", str(dist["process_id"])]
    if not _has_flag(out, "--resume") and int(env.get("SLURM_RESTART_COUNT",
                                                      "0") or "0") > 0:
        # requeued step: continue from the newest checkpoint of the
        # stage being relaunched
        output_dir, name = _probe_run_dir(out)
        ckpt = find_resume_ckpt(output_dir, name, stage2=stage2)
        if ckpt:
            out += ["--resume", ckpt]
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    stage2 = "--stage2" in argv
    if stage2:
        argv.remove("--stage2")
    argv = build_argv(argv, dict(os.environ), stage2=stage2)
    if stage2:
        from uvc_tpu_torch.cli.post_train import main as entry
    else:
        from uvc_tpu_torch.cli.joint_train import main as entry
    return entry(argv)


if __name__ == "__main__":
    main()
