"""The port's SLURM launcher (uvc_tpu_torch/cli/slurm_launch.py) against
the JAX package's (uvc_tpu/cli/slurm_launch.py, which imports no JAX):
the same coordinator, ranks and requeue resume from the same step
environment and run directory, over the common nodelist shapes; and the
port's copy enters the port's CLIs."""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import os

import pytest

from uvc_tpu.cli import slurm_launch as jslurm
from uvc_tpu_torch.cli import slurm_launch as tslurm

NODELISTS = ["host1,host2", "node[001-004]", "node[3,7-9]",
             "host1,node[3-4]", "tpu-[a,b]-host"]


def _run_dir(tmp_path):
    """A run directory with stage-1 and stage-2 checkpoints and an
    accuracy snapshot, their times set apart."""
    run = tmp_path / "out" / "r"
    run.mkdir(parents=True)
    for i, name in enumerate(["m_1.ckpt", "m_3.ckpt", "m_post_0.ckpt",
                              "m_post_2.ckpt", "m_best.ckpt"]):
        (run / name).write_bytes(b"x")
        os.utime(run / name, (10 + i, 10 + i))
    return str(tmp_path / "out")


@pytest.mark.parametrize("nodelist", NODELISTS)
def test_slurm_launch_matches_jax(tmp_path, nodelist):
    assert tslurm.first_host(nodelist) == jslurm.first_host(nodelist)
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
           "SLURM_STEP_NODELIST": nodelist}
    for extra in ({}, {"UVC_COORDINATOR": "10.0.0.5"},
                  {"UVC_COORDINATOR": "10.0.0.5:77",
                   "UVC_COORDINATOR_PORT": "99"},
                  {"UVC_COORDINATOR_PORT": "4242"}):
        e = dict(env, **extra)
        assert tslurm.derive_slurm_args(e) == jslurm.derive_slurm_args(e)
    assert tslurm.derive_slurm_args(env)["coordinator"] == \
        f"{jslurm.first_host(nodelist)}:{tslurm.DEFAULT_PORT}"
    assert tslurm.DEFAULT_PORT == jslurm.DEFAULT_PORT == 12321
    out = _run_dir(tmp_path)
    for stage2 in (False, True):
        assert tslurm.find_resume_ckpt(out, "r", stage2) == \
            jslurm.find_resume_ckpt(out, "r", stage2)
    requeued = dict(env, SLURM_RESTART_COUNT="1")
    for argv in (["--output_dir", out, "--name", "r"],
                 [f"--output_dir={out}", "--name=r", "--resume", "mine"],
                 ["--output_dir", out, "--name", "r",
                  "--coordinator=h:1"]):
        for stage2 in (False, True):
            for e in (env, requeued):
                assert tslurm.build_argv(argv, e, stage2) == \
                    jslurm.build_argv(argv, e, stage2)
    got = tslurm.build_argv(["--output_dir", out, "--name", "r"], requeued)
    assert got[got.index("--resume") + 1] == os.path.join(out, "r",
                                                          "m_3.ckpt")


def test_slurm_launch_enters_the_port_clis(monkeypatch):
    calls = {}
    import uvc_tpu_torch.cli.joint_train as jt
    import uvc_tpu_torch.cli.post_train as pt
    monkeypatch.setattr(jt, "main", lambda a: calls.setdefault("s1", a))
    monkeypatch.setattr(pt, "main", lambda a: calls.setdefault("s2", a))
    for var in ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_RESTART_COUNT"):
        monkeypatch.delenv(var, raising=False)
    tslurm.main(["--name", "x"])
    tslurm.main(["--stage2", "--checkpoint_dir", "d"])
    assert calls == {"s1": ["--name", "x"], "s2": ["--checkpoint_dir", "d"]}
