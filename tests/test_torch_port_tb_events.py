"""The port's TensorBoard event files (uvc_tpu_torch/utils/tb_events.py,
behind ``MetricLogger(enable_tensorboard=True)`` and ``--enable_writer
1``) against the JAX package's, which ``torch.utils.tensorboard``'s
``SummaryWriter`` writes.

Over one sequence of ``log_scalars`` the two loggers' files hold the same
records, field by field through tensorboard's own ``event_pb2`` (the wall
times aside), and the same bytes once the wall times are set equal;
tensorboard's reader takes every record of the port's file (it stops at
a frame whose CRC fails, shown on a corrupted copy); the file names
follow one pattern; ``tests/event_check.py`` reads both files alike; and
a ``tb`` directory that cannot be made raises where JAX's logger drops
the writer silently.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import math
import os
import re
import socket
import sys

import numpy as np
import pytest
import torch

from uvc_tpu.utils import logging as jlogging
from uvc_tpu_torch.utils import logging as tlogging
from uvc_tpu_torch.utils import tb_events

sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
import event_check  # noqa: E402

# one run's scalars: ints, bools, tensors and numpy scalars become floats;
# NaN, the infinities, -0.0, values past float32's range and a
# subnormal's are written; strings and None are not
SEQUENCE = [
    (0, {"train/loss": 2.25, "train/acc": 1, "lr": 1e-4}),
    (3, {"train/flops_real": 0.123456789, "nan": math.nan,
         "inf": -math.inf, "neg0": -0.0, "flag": True, "big": 1e300,
         "tiny": 1e-45, "text": "not a scalar", "none": None}),
    (-2, {"x": np.float32(0.1), "t": torch.tensor(2.5)}),
    (2 ** 40, {"test/accuracy": 0.5, "": 3.0}),
]


def _log(logger):
    for step, scalars in SEQUENCE:
        logger.log_scalars(step, scalars)


def _event_file(run_dir):
    files = os.listdir(os.path.join(run_dir, "tb"))
    assert len(files) == 1, files
    return os.path.join(run_dir, "tb", files[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(JAX's event file, the port's), after the same log_scalars."""
    out = tmp_path_factory.mktemp("tb")
    j = jlogging.MetricLogger(str(out), "jax", enable_tensorboard=True)
    _log(j)
    j._tb.close()
    t = tlogging.MetricLogger(str(out), "port", enable_tensorboard=True)
    _log(t)
    t.close()
    return _event_file(str(out / "jax")), _event_file(str(out / "port"))


def _raw_records(path):
    from tensorboard.backend.event_processing.event_file_loader import \
        RawEventFileLoader
    return list(RawEventFileLoader(path).Load())


def test_records_equal_torch_summary_writer(files):
    from tensorboard.compat.proto import event_pb2
    jraw, traw = (_raw_records(f) for f in files)
    # the header and one record per float scalar
    n_float = sum(1 for _, s in SEQUENCE for k, v in s.items()
                  if v is not None and not isinstance(v, str))
    assert len(jraw) == len(traw) == 1 + n_float
    for jr, tr in zip(jraw, traw):
        je, te = event_pb2.Event.FromString(jr), event_pb2.Event.FromString(tr)
        assert te.wall_time > 1e9 and je.wall_time > 1e9
        fields = lambda e: [(f.name, v) for f, v in e.ListFields()  # noqa
                            if f.name != "wall_time"]
        jf, tf = fields(je), fields(te)
        assert [n for n, _ in jf] == [n for n, _ in tf]
        for (name, jv), (_, tv) in zip(jf, tf):
            if name == "summary":
                (jv,), (tv,) = jv.value, tv.value
                assert jv.tag == tv.tag
                assert np.float32(jv.simple_value).tobytes() == \
                    np.float32(tv.simple_value).tobytes(), jv.tag
            else:
                assert jv == tv, name
        te.wall_time = je.wall_time
        assert te.SerializeToString() == je.SerializeToString()
        # the port's bytes are protobuf's serialisation of its record
        assert event_pb2.Event.FromString(tr).SerializeToString() == tr


def test_tensorboard_reader_checks_the_crcs(files, tmp_path):
    """Every record of the port's file passes tensorboard's reader; a
    frame whose CRC fails ends what the reader returns."""
    n = len(_raw_records(files[1]))
    blob = bytearray(open(files[1], "rb").read())
    blob[-2] ^= 0x40          # the last frame's data CRC
    bad = tmp_path / os.path.basename(files[1])
    bad.write_bytes(bytes(blob))
    assert len(_raw_records(str(bad))) == n - 1
    with pytest.raises(ValueError, match="data's CRC fails"):
        event_check.read_events(bad)


def test_file_names_follow_one_pattern(files):
    pattern = (r"events\.out\.tfevents\.(\d{10})\." + re.escape(
        socket.gethostname()) + r"\." + str(os.getpid()) + r"\.(\d+)$")
    stamps = [re.match(pattern, os.path.basename(f)) for f in files]
    assert all(stamps), files
    assert abs(int(stamps[0].group(1)) - int(stamps[1].group(1))) < 600


def test_event_check_reads_both_alike(files):
    jev, tev = (event_check.read_events(f) for f in files)
    assert tev[0] == {"wall_time": tev[0]["wall_time"], "step": 0,
                      "file_version": "brain.Event:2",
                      "source_writer":
                      "tensorboard.summary.writer.event_file_writer"}
    for j, t in zip(jev, tev):
        j.pop("wall_time"), t.pop("wall_time")
        assert repr(j) == repr(t)       # NaN equal to NaN
    steps = [e["step"] for e in tev[1:]]
    assert steps[:3] == [0, 0, 0] and steps[-1] == 2 ** 40
    assert ("x", float(np.float32(0.1))) in [s for e in tev[1:]
                                              for s in e["summary"]]


def test_writer_records_float32_and_negative_steps(tmp_path):
    w = tb_events.EventFileWriter(str(tmp_path))
    w.add_scalar("a", 1e300, -5, wall_time=0.0)
    w.add_scalar("b", float("nan"), 0, wall_time=12.5)
    w.close()
    w.close()
    head, a, b = event_check.read_events(w.path)
    assert head["file_version"] == "brain.Event:2"
    assert a == {"wall_time": 0.0, "step": -5,
                 "summary": [("a", math.inf)]}
    assert b["wall_time"] == 12.5 and math.isnan(b["summary"][0][1])


def test_unwritable_tb_directory_raises(tmp_path):
    """``--enable_writer 1`` that cannot open its file fails the run."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "tb").write_text("a file where the directory goes")
    with pytest.raises(OSError):
        tlogging.MetricLogger(str(tmp_path), "run", enable_tensorboard=True)
    tlogging.MetricLogger(str(tmp_path), "run").close()   # no writer asked
