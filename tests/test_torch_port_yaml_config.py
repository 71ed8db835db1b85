"""The port's YAML reader (uvc_tpu_torch/utils/yaml_config.py) against
``yaml.safe_load``, and ``--config`` through both packages' parsers.

Every document here that the reader takes must come back equal to what
PyYAML returns, type for type (NaN as NaN); every construct outside its
subset, and every document PyYAML itself rejects, must raise
``ValueError`` naming ``file:line:col`` at the right line.  The corpus:
the scalars PyYAML resolves unexpectedly (a YAML 1.1 reader, not 1.2),
``yaml.safe_dump(vars(args), default_flow_style=False)`` of the port's
joint_train, post_train and baseline_train parsers at their defaults (a
timm ``args.yaml``), a hypothesis run over flat dumps, and hand-written
files with comments, flow collections and escapes.  ``parse_with_config``
of the JAX package (PyYAML) and of the port (its reader) give equal
namespaces on each file both parsers take, and both call
``parser.error`` on an unknown key.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import argparse
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from uvc_tpu.cli import baseline_train as j_baseline
from uvc_tpu.cli import flags as jflags
from uvc_tpu.cli import slurm_launch as j_slurm
from uvc_tpu_torch.cli import baseline_train as t_baseline
from uvc_tpu_torch.cli import flags as tflags
from uvc_tpu_torch.cli import slurm_launch as t_slurm
from uvc_tpu_torch.utils import yaml_config

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import event_check  # noqa: E402


def same(a, b):
    """Equal, type for type, NaN equal to NaN, keys in the same order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    return a == b


def assert_reads_as_pyyaml(doc):
    want = yaml.safe_load(doc)
    got = yaml_config.loads(doc)
    assert same(got, want), (doc, got, want)


def assert_refused(doc, line):
    with pytest.raises(ValueError) as e:
        yaml_config.loads(doc, "cfg.yaml")
    m = re.match(r"cfg\.yaml:(\d+):(\d+): ", str(e.value))
    assert m and int(m.group(1)) == line, (doc, str(e.value))


# -- the scalars PyYAML resolves as YAML 1.1 does ----------------------------

QUIRKS = [
    ("lr: 1e-3", {"lr": "1e-3"}),
    ("1.0e3", "1.0e3"),
    ("1.0e-3", 0.001),
    ("1.5e+3", 1500.0),
    ("1.", 1.0),
    ("yes", True), ("On", True), ("NO", False), ("Yes", True), ("YES", True),
    ("yEs", "yEs"), ("y", "y"), ("n", "n"), ("off", False),
    ("017", 15), ("0o17", "0o17"), ("0x1F", 31), ("0b101", 5),
    ("1_000", 1000), ("+1", 1), ("-0", 0),
    ("1:30", 90), ("190:20:30", 685230), ("0:30", "0:30"), ("1:60", "1:60"),
    ("1:59.5", 119.5),
    (".inf", math.inf), ("-.Inf", -math.inf), (".NaN", math.nan),
    ("~", None), ("a:", {"a": None}), ("null", None), ("nUll", "nUll"),
    ("'1'", "1"), ('"yes"', "yes"),
    ("[0.9, 0.999]", [0.9, 0.999]),
    ("._5", "._5"), ("1.e+3", 1000.0), ("0x_1", 1), ("1__0", 10),
]


@pytest.mark.parametrize("doc,value", QUIRKS, ids=[q[0] for q in QUIRKS])
def test_scalars_resolve_as_pyyaml(doc, value):
    assert same(yaml.safe_load(doc), value)
    assert_reads_as_pyyaml(doc)
    assert_reads_as_pyyaml(f"key: {doc}\n" if ":" not in doc else doc)


def test_a_date_is_refused():
    """PyYAML returns a ``datetime.date``, a type no flag takes."""
    assert type(yaml.safe_load("2001-12-14")).__name__ == "date"
    assert_refused("a: 1\nb: 2001-12-14\n", 2)
    assert_refused("a: 2001-12-14 21:59:43.10 -5\n", 1)


# -- timm's args.yaml: safe_dump of the port's parsers at their defaults ----

def _parser(cli):
    if cli == "baseline_train":
        return t_baseline.build_parser()
    p = argparse.ArgumentParser()
    tflags.add_common_flags(p)
    tflags.add_uvc_flags(p)
    if cli == "post_train":
        tflags.add_stage2_flags(p)
    return p


class _Grabbed(Exception):
    """Raised in place of parsing, carrying the parser."""


def _jax_parser(cli):
    """The JAX package's parser for ``cli`` (baseline_train's is built in
    its ``main``, and taken from there)."""
    if cli == "baseline_train":
        def grab(parser, argv=None):
            raise _Grabbed(parser)
        real = jflags.parse_with_config
        jflags.parse_with_config = grab
        try:
            j_baseline.main([])
        except _Grabbed as e:
            return e.args[0]
        finally:
            jflags.parse_with_config = real
    p = argparse.ArgumentParser()
    jflags.add_common_flags(p)
    jflags.add_uvc_flags(p)
    if cli == "post_train":
        jflags.add_stage2_flags(p)
    return p


def timm_args_yaml(cli, drop=("device",)):
    args = vars(_parser(cli).parse_args([]))
    return yaml.safe_dump({k: v for k, v in args.items() if k not in drop},
                          default_flow_style=False)


CLIS = ["joint_train", "post_train", "baseline_train"]


@pytest.mark.parametrize("cli", CLIS)
def test_timm_args_yaml_reads_as_pyyaml(cli):
    doc = timm_args_yaml(cli, drop=())
    assert "device: cuda" in doc
    assert_reads_as_pyyaml(doc)


# -- hypothesis: flat dumps ---------------------------------------------------

LOOKALIKES = ["1e-3", "1.0", "017", "0o17", "0x1F", "yes", "No", "on", "y",
              "~", "null", "", " a", "1:30", ".inf", "true", "1_000", "-",
              "- a", "a: b", "a #b", "#", "'", '"', "[1]", "{a: 1}", "\\",
              "1.0e-05", "2001-12-14", "\t", "a\nb", "é"]
scalars = st.one_of(
    st.integers(-2 ** 70, 2 ** 70),
    st.floats(allow_nan=True, allow_infinity=True),
    st.booleans(), st.none(),
    st.sampled_from(LOOKALIKES),
    st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)),
            max_size=12))
values = st.one_of(scalars, st.lists(scalars, max_size=4))
flat = st.dictionaries(st.from_regex(r"[a-z][a-z0-9_\-]{0,10}",
                                     fullmatch=True), values, max_size=8)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(flat, st.sampled_from([False, None]), st.sampled_from([2, 4]),
       st.booleans())
def test_flat_dumps_read_as_pyyaml(d, flow, indent, unicode):
    doc = yaml.safe_dump(d, default_flow_style=flow, indent=indent,
                         allow_unicode=unicode)
    assert_reads_as_pyyaml(doc)


# -- hand-written files -------------------------------------------------------

HAND = {
    "comments": ("# timm args\n---\nlr: 1.0e-04   # the base rate\n"
                 "warmup_lr: 1e-4\n\n  # indented comment\nepochs: 300\n"
                 "opt_betas:\n- 0.9\n- 0.999  # adam\nname: run#1\n...\n"
                 "# after the end\n"),
    "flow": ("cutmix_minmax: [0.2, 0.8]\nnested: {a: [1, {b: c}], d: ~}\n"
             "multi: [1,\n  2, # two\n  3,\n]\nempty: {}\nnone: []\n"
             "json: {\"k\":1, 'q': 'x y'}\n"),
    "quoted": ("a: 'it''s'\nb: \"tab\\there \\x41\\u00e9\\U0001F600\"\n"
               "c: \"line\\nbreak \\\\ \\\"q\\\"\"\nd: 'two\n  lines\n\n"
               "  kept'\ne: \"fold \\\n   ed\"\nf: ''\n\"g h\": '1'\n"),
    "nested": ("model:\n  name: deit\n  depth: 12\n  heads:\n  - 6\n  - 6\n"
               "data:\n    - {path: /data, split: train}\n    - - 1\n"
               "      - 2\n-bad: key\nplain: a b\n  c d\n\n  e\n"),
    "keys": ("1: int key\nyes: bool key\n~: null key\n1.5: float key\n"
             "dup: first\ndup: last\n'quoted key' : 2\n"),
    "top_list": "- a\n-\n- - b\n  - c\n- d: 1\n  e: 2\n",
    "bom_crlf": "\ufeffa: 1\r\nb: [x,\r\n  y]\r\n",
    "empty": "",
    "comments_only": "# nothing\n\n---\n# still nothing\n",
    "top_scalar": "---\n'just a string'\n...\n",
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_written_files_read_as_pyyaml(name):
    assert_reads_as_pyyaml(HAND[name])


# -- what the reader refuses, and what PyYAML rejects -------------------------

REFUSED = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "literal": ("a: 1\nb: |\n  text\n", 2),
    "folded": ("b: >\n  text\n", 1),
    "complex_key": ("a: 1\n? b\n: c\n", 2),
    "merge": ("base: {x: 1}\n<<: {y: 2}\n", 2),
    "two_documents": ("a: 1\n---\nb: 2\n", 2),
    "document_after_end": ("a: 1\n...\nb: 2\n", 3),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "timestamp": ("a: 2001-12-14\n", 1),
    "flow_single_pair": ("a: [b: 1]\n", 1),
    "cr_line_break": ("a: 1\rb: 2\n", 1),
    "content_on_marker": ("--- {a: 1}\n", 1),
}
# documents PyYAML itself rejects
REJECTED = {
    "value_in_value": ("x: 1\nk: a: b\n", 2),
    "seq_in_value": ("k: - a\n", 1),
    "no_colon": ("a: 1\nb\n", 2),
    "deeper_key": ("a: 1\n b: 2\n", 2),
    "shallower_key": ("a:\n  b: 1\n c: 2\n", 3),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "tab_value": ("a:\tb\n", 1),
    "unclosed_quote": ("a: 'b\n", 1),
    "unclosed_flow": ("a: [1, 2\n", 1),
    "bad_escape": ("a: \"\\q\"\n", 1),
    "junk_after_quote": ("a: 'b' c\n", 1),
    "junk_after_flow": ("a: [b]c\n", 1),
    "empty_flow_entry": ("a: [, b]\n", 1),
    "alias_undefined": ("a: *nowhere\n", 1),
    "reserved": ("a: @x\n", 1),
    "bad_binary": ("a: 0b_\n", 1),
    "comment_then_more": ("a: b\n  # c\n  d\n", 3),
    "control_char": ("a: \x01\n", 1),
    "flow_key_colon_next_line": ("a: {'k'\n: v}\n", 2),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_constructs_name_their_line(name):
    doc, line = REFUSED[name]
    assert_refused(doc, line)


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_pyyaml_rejections_raise_naming_their_line(name):
    doc, line = REJECTED[name]
    # a YAMLError, or the constructor's own ValueError ("0b_")
    with pytest.raises((yaml.YAMLError, ValueError)):
        yaml.safe_load(doc)
    assert_refused(doc, line)


def test_load_names_the_file(tmp_path):
    f = tmp_path / "args.yaml"
    f.write_text(HAND["comments"])
    assert same(yaml_config.load(f), yaml.safe_load(HAND["comments"]))
    f.write_text("a: 1\nb: &x 2\n")
    with pytest.raises(ValueError, match=re.escape(f"{f}:2:4: ")):
        yaml_config.load(f)


# -- --config through both packages' parsers ---------------------------------

def _corpus(cli):
    """Config files for ``cli``'s parser: its timm dump and hand-written
    ones over its flags."""
    out = {"timm": timm_args_yaml(cli)}
    out["hand"] = ("# a hand-written config\nlearning_rate: 1e-3\n"
                   "weight_decay: 1.0e-02\nname: 'run: one'\n"
                   "num_epochs: 0x10\nmodel_path: ~\nfp16: yes\n"
                   "output_dir: \"out\\tdir\"\neval_batch_size: '32'\n"
                   "cutmix_minmax: [0.2, 0.8]\n")
    if cli == "post_train":
        out["hand"] += "opt_betas:\n- 0.8\n- 0.99\nsched: cosine\n"
    return out


@pytest.mark.parametrize("cli", CLIS)
def test_parse_with_config_matches_jax(tmp_path, cli):
    """Equal namespaces from PyYAML's and the reader's values, the command
    line beating the file; an unknown key is ``parser.error`` in both."""
    for name, doc in _corpus(cli).items():
        f = tmp_path / f"{cli}_{name}.yaml"
        f.write_text(doc)
        argv = ["-c", str(f), "--seed", "3"]
        ja = jflags.parse_with_config(_jax_parser(cli), argv)
        ta = tflags.parse_with_config(_parser(cli), argv)
        tv = vars(ta)
        tv.pop("device")
        assert same(tv, vars(ja)), name
        assert ta.seed == 3
    assert ta.learning_rate == 1e-3 and ta.num_epochs == 16
    assert ta.name == "run: one" and ta.fp16 is True
    assert ta.eval_batch_size == 32 and ta.output_dir == "out\tdir"
    bad = tmp_path / "bad.yaml"
    bad.write_text("learning_rate: 0.1\nno_such_flag: 1\n")
    for mod, parser in ((jflags, _jax_parser(cli)), (tflags, _parser(cli))):
        with pytest.raises(SystemExit):
            mod.parse_with_config(parser, ["-c", str(bad)])


def test_slurm_probe_reads_the_config_as_jax(tmp_path):
    """``_probe_run_dir`` sees a config's output_dir / name as JAX's does,
    the command line winning; a file the reader refuses is a best-effort
    miss, as a malformed one is for PyYAML."""
    f = tmp_path / "c.yaml"
    cases = [("output_dir: /o\nname: 'n 1'\n", []),
             ("output_dir: /o\nname: n\n", ["--name", "cli"]),
             ("name: n  # comment\n", ["--output_dir=/x"]),
             ("a: [1\n", []), ("name: &x n\n", [])]
    for doc, extra in cases:
        f.write_text(doc)
        argv = ["-c", str(f)] + extra
        want = j_slurm._probe_run_dir(argv)
        if doc.startswith("name: &x"):
            # PyYAML takes the anchor; the reader refuses it
            want = ("output/uvc_train", "debug")
        assert t_slurm._probe_run_dir(argv) == want, doc
    assert t_slurm._probe_run_dir(["-c", str(tmp_path / "none")]) == \
        ("output/uvc_train", "debug")


# -- the port's CLI with neither yaml, tensorboard nor protobuf --------------

NO_DEPS = ("import sys\n"
           "for m in ('yaml', 'tensorboard', 'torch.utils.tensorboard',"
           " 'google.protobuf'):\n"
           "    sys.modules[m] = None\n")


def test_joint_train_config_and_writer_without_yaml_or_tensorboard(
        tmp_path):
    """``joint_train --device cpu -c args.yaml --enable_writer 1`` at the
    tiny size in a process where yaml, tensorboard and protobuf cannot be
    imported: the file's values take effect (the command line beating
    it), and the event file holds every float scalar of metrics.jsonl."""
    cfg = tmp_path / "args.yaml"
    cfg.write_text(
        "# timm-style args.yaml\nmodel_type: testing\ndataset: synthetic\n"
        "img_size: 32\ntrain_batch_size: 16\neval_batch_size: 8\n"
        "synthetic_steps: 3\nnum_epochs: 2\nwarmup_epochs: 1\n"
        "post_num_epochs: 0\ncutmix_minmax:\n- 0.2\n- 0.8\n"
        "teacher_path: null\nfp16: false\nbudget: '0.5'\n"
        "learning_rate: 1.0e-04\nylr: 1e-4\nlog_interval: 1\n"
        "distillation_type: soft\n")
    run = tmp_path / "run"
    argv = ["-c", str(cfg), "--train_batch_size", "8", "--device", "cpu",
            "--dp", "1", "--enable_writer", "1", "--output_dir",
            str(tmp_path), "--name", "run"]
    code = NO_DEPS + (
        "for m in ('yaml', 'tensorboard', 'torch.utils.tensorboard',"
        " 'google.protobuf'):\n"
        "    try:\n"
        "        __import__(m)\n"
        "    except ImportError:\n"
        "        continue\n"
        "    raise SystemExit(m + ' imports')\n"
        "from uvc_tpu_torch.cli import joint_train\n"
        f"joint_train.main({argv!r})\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    params = re.search(r"Training parameters Namespace\((.*)\)",
                       res.stdout).group(1)
    for want in ("train_batch_size=8", "eval_batch_size=8",
                 "cutmix_minmax=[0.2, 0.8]", "teacher_path=None",
                 "budget='0.5'", "learning_rate=0.0001", "ylr=0.0001",
                 "distillation_type='soft'", "log_interval=1"):
        assert want in params, want
    tb = [f for f in os.listdir(run / "tb")]
    assert len(tb) == 1
    n = event_check.match_jsonl(run / "tb" / tb[0], run / "metrics.jsonl")
    assert n >= 6
