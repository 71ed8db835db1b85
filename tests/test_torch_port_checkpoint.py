"""The port's checkpoint codec (uvc_tpu_torch/utils/checkpoint.py) against
``msgpack`` and ``flax.serialization``, and the checkpoint files of the
two packages' drivers read across, on the CPU.

The codec must write the bytes that flax writes for the same tree, so
the files compare byte for byte; what it reads must equal, leaf for leaf
and bit for bit, what flax reads.  The drivers' trees (stage 1: params,
cstate, the AdamW state, masks and the scalar fields; stage 2 with AdamW
and with SGD) are built as the JAX drivers build them, from JAX train
states whose moments are filled with seeded values.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress.minimax import init_compression_state
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu.utils import checkpoint as jckpt
from uvc_tpu_torch.interop import params_from_numpy
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.utils import checkpoint as tckpt
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

CFG = jconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                             depth=3, num_classes=7)


def same(a, b):
    """Bit-for-bit equality of a port leaf and a flax leaf."""
    if torch.is_tensor(a):
        ref = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert ref.dtype == jnp.bfloat16
            a = a.view(torch.int16).numpy()
            ref = ref.view(np.int16)
        else:
            a = a.numpy()
        assert a.dtype == ref.dtype and a.shape == ref.shape
        assert a.tobytes() == ref.tobytes()
    elif isinstance(b, np.ndarray) and b.shape == () and b.dtype.kind == "U":
        assert a == b.item()
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b, (a, b)


def same_tree(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            same_tree(a[k], b[k])
    elif b is None:
        assert a is None
    else:
        same(a, b)


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, float("inf"), "", "a" * 31,
    "b" * 32, "c" * 300, "d" * 70000, "é", b"", b"xx", b"y" * 300,
    b"z" * 70000, [], [1, [2, [3]]], list(range(20)), {}, {"a": {"b": {}}},
    {str(i): i for i in range(20)}, {"k": [None, 1.5, "s", b"b"]},
], ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__")
                                          else o)[:12])
def test_codec_matches_msgpack(obj):
    ours = tckpt.packb(obj)
    assert ours == msgpack.packb(obj)
    assert tckpt.unpackb(ours) == msgpack.unpackb(ours)
    assert tckpt.unpackb(ours, raw=True) == msgpack.unpackb(ours, raw=True)


def test_codec_rejects_what_it_cannot_store():
    with pytest.raises(TypeError):
        tckpt.packb({"x": object()})
    with pytest.raises(ValueError):
        tckpt.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(ValueError):
        tckpt.unpackb(msgpack.packb(1) + b"\x00")


def _leaf_trees():
    rng = np.random.default_rng(0)
    return {
        "f32": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
        "bf16": {"w": jnp.asarray(rng.standard_normal((4, 6)),
                                  jnp.bfloat16)},
        "ints": {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
                 "b": np.arange(-3, 3, dtype=np.int64),
                 "c": np.arange(4, dtype=np.uint8),
                 "d": np.array([True, False])},
        "np_scalars": {"i": np.int32(7), "f": np.float32(2.5),
                       "d": np.float64(-1.25), "b": np.bool_(True)},
        "py_scalars": {"i": 3, "f": 0.25, "b": False, "n": None, "s": "x",
                       "c": 1 + 2j},
        "nested": {"z": {"y": {"x": np.ones((2, 2), np.float16)}},
                   "a": {"e": {}}, "m": {}},
        "empty": {},
        "zero_size": {"e": np.zeros((0, 3), np.float32)},
    }


def _numpy_leaves(tree):
    """``tree`` with its JAX arrays as numpy arrays, the dict order kept
    (``jax.tree.map`` would sort the keys)."""
    if isinstance(tree, dict):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


@pytest.mark.parametrize("kind", sorted(_leaf_trees()))
def test_codec_matches_flax_bytes(kind):
    """flax's ``to_bytes`` and the port's encoding of the same tree are the
    same bytes, and both readers return the same leaves."""
    tree = _leaf_trees()[kind]
    ref = serialization.to_bytes(tree)
    assert tckpt.msgpack_serialize(_numpy_leaves(tree)) == ref
    same_tree(tckpt.msgpack_restore(ref), serialization.msgpack_restore(ref))


def test_tensor_leaves_encode_as_flax_arrays():
    """A tensor leaf is stored as the ndarray of its values (bf16 through
    its bytes), flax's reader gives back the same values."""
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(1)),
            "h": torch.randn(5).to(torch.bfloat16),
            "i": torch.arange(4, dtype=torch.int32),
            "s": torch.tensor(2.5)}
    back = serialization.msgpack_restore(tckpt.msgpack_serialize(tree))
    same_tree({k: tree[k] for k in back}, back)
    ref = serialization.to_bytes(
        {"w": tree["w"].numpy(), "h": jnp.asarray(tree["h"].float().numpy(),
                                                  jnp.bfloat16),
         "i": tree["i"].numpy(), "s": tree["s"].numpy()})
    assert tckpt.msgpack_serialize(tree) == ref


def test_chunked_leaves(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes are stored in flat chunks, as flax
    stores them (the limit lowered on both sides for this test only)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"big": rng.standard_normal((5, 7)).astype(np.float32),
            "odd": np.arange(33, dtype=np.int64),
            "small": np.ones(4, np.float32),
            "inner": {"big": rng.standard_normal((3, 3, 3)).astype(
                np.float64)}}
    ref = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in ref
    assert tckpt.msgpack_serialize(tree) == ref
    same_tree(tckpt.msgpack_restore(ref), serialization.msgpack_restore(ref))
    back = tckpt.msgpack_restore(tckpt.msgpack_serialize(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in tree.items()}))
    assert back["big"].shape == (5, 7)
    same(back["odd"], tree["odd"])


def test_save_checkpoint_writes_jax_bytes(tmp_path):
    """``save_checkpoint`` writes the JAX package's ``save_checkpoint``
    bytes for one tree: dict keys sorted, lists as maps of their indices,
    Python scalars and strings as 0-d arrays; and reads back what it
    wrote, the string as ``str``, the numbers as 0-d tensors."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    jtree = {"z": {"w": jnp.asarray(w)}, "a": 1, "l": [np.zeros(2), None, 2.0],
             "m": "deit_small_patch16_224", "t": True,
             "layers": [{"num_heads": 3}] * 11}
    ttree = {"z": {"w": torch.from_numpy(w)}, "a": 1,
             "l": [torch.zeros(2, dtype=torch.float64), None, 2.0],
             "m": "deit_small_patch16_224", "t": True,
             "layers": [{"num_heads": 3}] * 11}
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), jtree)
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), ttree)
    assert (tmp_path / "j.ckpt").read_bytes() == \
        (tmp_path / "t.ckpt").read_bytes()
    back = tckpt.load_checkpoint(str(tmp_path / "t.ckpt"))
    assert back["m"] == "deit_small_patch16_224"
    assert int(back["a"]) == 1 and bool(back["t"])
    assert list(back["layers"]) == [str(i) for i in range(11)]
    assert int(back["layers"]["10"]["num_heads"]) == 3
    assert torch.equal(back["z"]["w"], ttree["z"]["w"])


# ---------------------------------------------------------------------------
# the drivers' checkpoints, across the packages
# ---------------------------------------------------------------------------


def _filled(tree, seed):
    """``tree`` with every float leaf replaced by seeded values (moments
    that a step would have filled)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return jnp.asarray(a)
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))
    return jax.tree.map(fill, tree)


def _jax_tree(kind, seed=0):
    """A checkpoint tree as the JAX drivers build it: stage 1 (AdamW,
    cstate with the tiny optimizers' traces) or stage 2 (AdamW / SGD)."""
    params = jvit.init_params(jax.random.PRNGKey(seed), CFG)
    opt = {"stage1": "adamw", "stage2_adamw": "adamw",
           "stage2_sgd": "sgd"}[kind]
    thp = jstate.TrainHParams(opt=opt)
    hp = JHParams(soptim="adam", roptim="sgd")
    st = jstate.create_train_state(params, thp,
                                   init_compression_state(CFG, hp))
    opt_state = _filled(st.opt_state, seed + 1)
    opt_state = jax.tree.map(
        lambda a: (jnp.asarray(5, a.dtype) if a.dtype == jnp.int32 else a),
        opt_state)
    masks = {"attn": jnp.ones((CFG.depth, CFG.embed_dim)).at[0, :3].set(0.0),
             "mlp": jnp.ones((CFG.depth, CFG.mlp_hidden)).at[1, 5:].set(0.0)}
    if kind == "stage1":
        cstate = _filled(st.cstate, seed + 2).replace(
            s_opt=st.cstate.s_opt.replace(count=jnp.asarray(4, jnp.int32)))
        return {"params": params,
                "cstate": serialization.to_state_dict(cstate),
                "opt_state": serialization.to_state_dict(opt_state),
                "masks": masks, "epoch": 2, "step": 6, "global_step": 6,
                "key_seed": 44}
    return {"params": params, "compact": False,
            "opt_state": serialization.to_state_dict(opt_state),
            "masks": masks, "epoch": 0, "global_step": 3, "best_acc": 0.25,
            "key_seed": 10042}


def _port_state(jtree, kind):
    """The port's optimizer state and cstate holding the JAX tree's
    values."""
    params = params_from_numpy(jax.tree.map(np.asarray, jtree["params"]),
                               device="cpu")
    opt = "sgd" if kind == "stage2_sgd" else "adamw"
    like = tstate.create_train_state(
        params, tstate.TrainHParams(opt=opt)).opt_state
    sd = tckpt.msgpack_restore(tckpt.to_bytes(jax.tree.map(
        np.asarray, jtree["opt_state"])))
    return params, tstate.opt_state_from_state_dict(sd, like)


@pytest.mark.parametrize("kind", ["stage1", "stage2_adamw", "stage2_sgd"])
def test_jax_driver_checkpoint_read_by_the_port(tmp_path, kind):
    """A JAX driver's checkpoint, read by the port's codec, restores into
    the port's optimizer state and cstate leaf for leaf bit for bit."""
    jtree = _jax_tree(kind)
    path = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(path, jtree)
    ck = tckpt.load_checkpoint(path)
    same_tree(ck, jckpt.load_checkpoint(path))
    assert int(ck["epoch"]) == jtree["epoch"]
    assert int(ck["key_seed"]) == jtree["key_seed"]
    assert int(ck["global_step"]) == jtree["global_step"]

    params, like = _port_state(jtree, kind)
    restored = tckpt.restore_like(params, ck["params"])
    for path_, leaf in tree_leaves_with_path(restored):
        ref = jtree["params"]
        for k in path_:
            ref = ref[k]
        same(leaf, np.asarray(ref))
    opt = tstate.opt_state_from_state_dict(ck["opt_state"], like)
    jopt = jtree["opt_state"]
    if kind == "stage2_sgd":
        assert isinstance(opt, tstate.SGDState) and opt.count == 5
        pairs = [(opt.trace, jopt["1"]["0"]["trace"])]
    else:
        assert isinstance(opt, tstate.AdamWState) and opt.count == 5
        pairs = [(opt.mu, jopt["0"]["mu"]), (opt.nu, jopt["0"]["nu"])]
    for mine, ref in pairs:
        for path_, leaf in tree_leaves_with_path(mine):
            r = ref
            for k in path_:
                r = r[k]
            same(leaf, np.asarray(r))
    if kind == "stage1":
        cs = tstate.cstate_from_state_dict(ck["cstate"], "cpu")
        jcs = jtree["cstate"]
        for f in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
            same(getattr(cs, f), np.asarray(jcs[f]))
        assert cs.s_opt.count == 4 and cs.s_opt.v is not None
        same(cs.s_opt.v, np.asarray(jcs["s_opt"]["v"]))
        assert cs.r_opt.v is None and jcs["r_opt"]["v"] is None


@pytest.mark.parametrize("kind", ["stage1", "stage2_adamw", "stage2_sgd"])
def test_port_driver_checkpoint_read_by_jax(tmp_path, kind):
    """The port's driver tree (its optimizer state and cstate through the
    layout converters) is written as the same bytes as the JAX driver's,
    and JAX's ``load_checkpoint`` restores it into JAX's train state."""
    jtree = _jax_tree(kind)
    params, opt = _port_state(jtree, kind)
    ttree = dict(jtree, params=params,
                 opt_state=tstate.opt_state_to_state_dict(opt),
                 masks={k: torch.from_numpy(np.array(v))
                        for k, v in jtree["masks"].items()})
    if kind == "stage1":
        cs_sd = tckpt.msgpack_restore(tckpt.to_bytes(jax.tree.map(
            np.asarray, jtree["cstate"])))
        ttree["cstate"] = tstate.cstate_to_state_dict(
            tstate.cstate_from_state_dict(cs_sd, "cpu"))
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), jtree)
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), ttree)
    assert (tmp_path / "t.ckpt").read_bytes() == \
        (tmp_path / "j.ckpt").read_bytes()
    ck = jckpt.load_checkpoint(str(tmp_path / "t.ckpt"))
    thp = jstate.TrainHParams(opt="sgd" if kind == "stage2_sgd" else "adamw")
    jst = jstate.create_train_state(jtree["params"], thp)
    back = serialization.from_state_dict(jst.opt_state, ck["opt_state"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            serialization.from_state_dict(jst.opt_state,
                                          jtree["opt_state"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_like_checks_the_structure():
    tree = {"a": torch.zeros(2), "l": [torch.ones(3)]}
    state = tckpt.msgpack_restore(tckpt.to_bytes(tree))
    back = tckpt.restore_like(tree, state)
    assert isinstance(back["l"], list) and torch.equal(back["l"][0],
                                                       torch.ones(3))
    with pytest.raises(ValueError, match="no keys"):
        tckpt.restore_like({"b": torch.zeros(2)}, state)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_like({"a": torch.zeros(3), "l": [torch.ones(3)]},
                           state)


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3, 5, 8):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert mgr.all_steps() == [3, 5, 8] and mgr.latest_step() == 8
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["3.ckpt", "5.ckpt", "8.ckpt"]
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 8.0))
    assert int(mgr.restore(5)["step"]) == 5
    back = mgr.restore(3, target={"w": torch.zeros(2), "step": 0})
    assert torch.equal(back["w"], torch.full((2,), 3.0))
    # the files are the JAX package's: its reader takes them
    assert int(jckpt.load_checkpoint(str(tmp_path / "ck" / "8.ckpt"))
               ["step"]) == 8
