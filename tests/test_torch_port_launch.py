"""The port's launch recipes (``uvc_tpu_torch/scripts/*.sh``,
``run_slurm.sbatch``) against the JAX package's (``scripts/``), and its
packaging.

Each recipe runs under bash with stand-ins for ``python``, ``torchrun`` and
``srun`` first on ``PATH``, which record the command lines they are given
and run nothing: each command of the port's recipe is the JAX recipe's
with the module ``uvc_tpu.cli.X`` as ``uvc_tpu_torch.cli.X``, and both
parse (each with its own package's parser) to the same values but the
port's ``--device``.  The multi-host recipe hands the JAX recipe's
``--coordinator`` / ``--num_processes`` / ``--process_id`` to torchrun,
one process per GPU; the SLURM recipe runs one task per GPU.  ImageNet and
the ``.pth`` files are not here, so nothing trains.

The wheel is built offline from a copy of ``pyproject.toml``, ``README.md``
and the two packages in a temporary directory.
"""

import argparse
import json
import os
import shlex
import shutil
import stat
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from uvc_tpu.cli import baseline_train as j_base
from uvc_tpu.cli import generate_mask as j_mask
from uvc_tpu.cli import joint_train as j_joint
from uvc_tpu.cli import post_train as j_post
from uvc_tpu_torch.cli import baseline_train as t_base
from uvc_tpu_torch.cli import generate_mask as t_mask
from uvc_tpu_torch.cli import joint_train as t_joint
from uvc_tpu_torch.cli import post_train as t_post
from uvc_tpu_torch.ops import _cuda

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "scripts"
PORT_DIR = REPO / "uvc_tpu_torch" / "scripts"
RECIPES = ["run_uvc_train.sh", "run_post_train.sh", "run_baseline_gmp.sh",
           "run_mask_finetune.sh", "run_multihost.sh", "run_slurm.sbatch"]
MAINS = {"joint_train": (j_joint.main, t_joint.main),
         "post_train": (j_post.main, t_post.main),
         "baseline_train": (j_base.main, t_base.main),
         "generate_mask": (j_mask.main, t_mask.main)}
ENV = {"COORDINATOR": "10.1.2.3:4567", "NUM_HOSTS": "3", "HOST_ID": "2",
       "GPUS_PER_HOST": "1"}
EXTRA = ["--name", "recipe"]


def _stubs(tmp_path):
    """A directory of stand-ins that append their name and arguments to
    ``$RECORD`` as one JSON line; ``srun`` then runs its command."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    record = (f'"{sys.executable}" -c "import json, os, sys; '
              f'open(os.environ[\'RECORD\'], \'a\').write('
              f'json.dumps(sys.argv[1:]) + chr(10))" "$(basename "$0")" "$@"')
    for name in ("python", "python3", "torchrun", "srun", "scontrol"):
        body = record + ("\nexec \"$@\"" if name == "srun" else "")
        path = bindir / name
        path.write_text("#!/bin/bash\n" + body + "\n")
        path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return bindir


def _commands(tmp_path, script, args=()):
    bindir = tmp_path / "bin"
    if not bindir.exists():
        _stubs(tmp_path)
    side = "port" if script.parent == PORT_DIR else "jax"
    rec = tmp_path / f"{side}_{script.name}.jsonl"
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               RECORD=str(rec), **ENV)
    subprocess.run(["bash", str(script), *args], env=env, check=True,
                   cwd=tmp_path, timeout=60)
    return [json.loads(line) for line in rec.read_text().splitlines()]


class _Parsed(Exception):
    pass


def _parse(main, argv, monkeypatch):
    """The namespace ``main``'s own parser makes of ``argv`` (every token
    taken)."""
    real = argparse.ArgumentParser.parse_known_args

    def fake(self, args=None, namespace=None):
        ns, rest = real(self, args, namespace)
        if self.add_help:                     # not the --config pre-parser
            raise _Parsed(ns, rest)
        return ns, rest

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", fake)
    with pytest.raises(_Parsed) as e:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", real)
    ns, rest = e.value.args
    assert rest == [], rest
    return vars(ns)


def _module_call(cmd):
    """``(module, arguments)`` of ``python -m module arguments``."""
    assert cmd[0] in ("python", "python3") and cmd[1] == "-m", cmd
    return cmd[2], cmd[3:]


def _same_cli(jcmd, tcmd, monkeypatch):
    jmod, jargs = _module_call(jcmd)
    tmod, targs = _module_call(tcmd)
    assert jmod.startswith("uvc_tpu.cli.")
    assert tmod == "uvc_tpu_torch.cli." + jmod[len("uvc_tpu.cli."):]
    assert targs == jargs
    cli = jmod.rsplit(".", 1)[1]
    if cli == "slurm_launch":                 # forwards to joint_train
        cli = "joint_train"
    jmain, tmain = MAINS[cli]
    jv = _parse(jmain, jargs, monkeypatch)
    tv = _parse(tmain, targs, monkeypatch)
    assert tv.pop("device") == "cuda"
    assert tv == jv


def _sbatch(path):
    """The ``#SBATCH`` options: value, or None for a bare switch."""
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith("#SBATCH "):
            key, _, value = line[len("#SBATCH "):].partition("=")
            out[key] = value or None
    return out


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_is_jaxs(recipe, tmp_path, monkeypatch):
    jcmds = _commands(tmp_path, JAX_DIR / recipe, EXTRA)
    tcmds = _commands(tmp_path, PORT_DIR / recipe, EXTRA)
    assert len(tcmds) == len(jcmds) > 0
    if recipe == "run_multihost.sh":
        (jcmd,), (tcmd,) = jcmds, tcmds
        # the rendezvous goes to torchrun, one process per GPU
        rdv = {"--coordinator": ENV["COORDINATOR"],
               "--num_processes": ENV["NUM_HOSTS"],
               "--process_id": ENV["HOST_ID"]}
        jargs = _module_call(jcmd)[1]
        for flag, value in rdv.items():
            i = jargs.index(flag)
            assert jargs[i + 1] == value
            del jargs[i:i + 2]
        assert tcmd[0] == "torchrun"
        m = tcmd.index("-m")
        opts = dict(zip(tcmd[1:m:2], tcmd[2:m:2]))
        host, port = ENV["COORDINATOR"].split(":")
        assert opts == {"--nnodes": ENV["NUM_HOSTS"],
                        "--node_rank": ENV["HOST_ID"],
                        "--nproc_per_node": ENV["GPUS_PER_HOST"],
                        "--master_addr": host, "--master_port": port}
        jcmds, tcmds = [["python", "-m", jcmd[2], *jargs]], [
            ["python", *tcmd[m:]]]
    if recipe == "run_slurm.sbatch":
        # srun, then the command it runs
        assert [c[0] for c in tcmds] == [c[0] for c in jcmds] == \
            ["srun", "python"]
        assert tcmds[0][1:] == tcmds[1] and jcmds[0][1:] == jcmds[1]
        jcmds, tcmds = jcmds[1:], tcmds[1:]
        jb, tb = _sbatch(JAX_DIR / recipe), _sbatch(PORT_DIR / recipe)
        # one task per GPU, not per host
        assert jb.pop("--ntasks-per-node") == "1"
        assert tb.pop("--ntasks-per-node") == tb.pop("--gpus-per-node")
        assert tb == jb
    for jcmd, tcmd in zip(jcmds, tcmds):
        _same_cli(jcmd, tcmd, monkeypatch)


def _chain(path):
    """The ``run <name> <command>`` lines of a record chain."""
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith("run "):
            words = shlex.split(line)
            out[words[1]] = words[2:]
    return out


def test_h100_chain_is_the_r5_chain_on_the_card(tmp_path):
    """The same steps as ``scripts/r5_chain.sh``, the harnesses at its
    seeds writing the H100 records, each under a timeout of at most half
    an hour; the TPU's kernel parity becomes ``chip_smoke.py``'s."""
    jc, tc = _chain(JAX_DIR / "r5_chain.sh"), _chain(PORT_DIR /
                                                      "h100_chain.sh")
    assert list(tc) == list(jc)
    for name, cmd in tc.items():
        assert cmd[0] == "timeout" and 0 < int(cmd[1]) <= 1800, cmd
        assert jc[name][0] == "timeout"
        jrun, trun = jc[name][2:], cmd[2:]
        if name == "kparity":
            assert jrun[:2] == ["python", "scripts/tpu_kernel_parity.py"]
            assert trun == ["python3", "chip_smoke.py", "--kernels-only"]
            continue
        harness = Path(jrun[1]).stem
        assert trun[:3] == ["python3", "-m",
                            f"uvc_tpu_torch.scripts.{harness}"]
        jargs, targs = jrun[2:], trun[3:]
        jout, tout = jargs.index("--out"), targs.index("--out")
        if harness == "e2e_accuracy":
            seed = jargs[jargs.index("--seed") + 1]
            assert targs[targs.index("--seed") + 1] == seed
            assert targs[tout + 1] == f"E2EACC_h100_seed{seed}.json"
        else:
            assert targs[tout + 1] == "FIDELITY_h100.json"
        assert len(targs) == len(jargs)
    # it runs: every step once, logged where LOG says
    bindir = _stubs(tmp_path)
    rec, log = tmp_path / "chain.jsonl", tmp_path / "log" / "chain.log"
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               RECORD=str(rec), LOG=str(log))
    (tmp_path / "timeout").write_text(
        "#!/bin/bash\nshift\nexec \"$@\"\n")
    (tmp_path / "timeout").chmod(0o755)
    shutil.move(str(tmp_path / "timeout"), str(bindir / "timeout"))
    subprocess.run(["bash", str(PORT_DIR / "h100_chain.sh")], env=env,
                   check=True, timeout=60)
    ran = [json.loads(line) for line in rec.read_text().splitlines()]
    assert [c[1:] for c in ran] == [tc[n][3:] for n in tc]
    assert log.read_text().count("exit=0") == len(tc)


def test_build_root_is_the_checkout_or_the_user_cache(tmp_path,
                                                     monkeypatch):
    """A package in a checkout builds into the checkout's
    ``build/uvc_tpu_torch``; one with no ``pyproject.toml`` beside it (an
    installed wheel) into the user's cache directory."""
    assert _cuda._BUILD_ROOT == REPO / "build" / "uvc_tpu_torch"
    site = tmp_path / "site-packages"
    (site / "uvc_tpu_torch").mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _cuda.build_root(site / "uvc_tpu_torch") == \
        tmp_path / "cache" / "uvc_tpu_torch" / "build"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _cuda.build_root(site / "uvc_tpu_torch") == \
        tmp_path / "home" / ".cache" / "uvc_tpu_torch" / "build"


def test_wheel_ships_the_sources_recipes_and_entry_points(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for f in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / f, src / f)
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "build")
    for pkg in ("uvc_tpu", "uvc_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=skip)
    env = dict(os.environ, PIP_NO_INDEX="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                    "--no-build-isolation", "-q",
                    "-w", str(tmp_path / "dist")],
                   cwd=src, env=env, check=True, timeout=300,
                   capture_output=True)
    (whl,) = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
        (ep,) = [n for n in names if n.endswith("entry_points.txt")]
        entry = z.read(ep).decode()
    for f in sorted((REPO / "uvc_tpu_torch" / "csrc").iterdir()):
        if f.suffix in (".cu", ".cuh"):
            assert f"uvc_tpu_torch/csrc/{f.name}" in names, f.name
    image_srcs = sorted((REPO / "uvc_tpu_torch" / "csrc" / "image").glob(
        "*.[ch]*"))
    assert {f.suffix for f in image_srcs} == {".cpp", ".h"}
    for f in image_srcs:
        assert f"uvc_tpu_torch/csrc/image/{f.name}" in names, f.name
    assert "uvc_tpu_torch/data/imagelib.py" in names
    for recipe in RECIPES + ["h100_chain.sh"]:
        assert f"uvc_tpu_torch/scripts/{recipe}" in names, recipe
    assert "uvc_tpu_torch/ops/_cuda.py" in names
    for cli, module in (("joint-train", "joint_train"),
                        ("post-train", "post_train"),
                        ("baseline-train", "baseline_train"),
                        ("generate-mask", "generate_mask"),
                        ("export-compact", "export_compact"),
                        ("show-gradient-sparsity", "show_gradient_sparsity"),
                        ("slurm-launch", "slurm_launch")):
        assert (f"uvc-torch-{cli} = uvc_tpu_torch.cli.{module}:main"
                in entry), cli
