"""The port's pruning scorers (uvc_tpu_torch/baselines/pruning.py: Taylor,
SynFlow, SP and ``head_masks_to_weight_masks``) against the JAX package's,
on the CPU, in f32.

Both packages score the same weights (carried across with
``interop.params_from_numpy``) on the same batches.  Scores agree within
1e-5 relative Frobenius per leaf (SynFlow's 2e-5, see SYNFLOW_TOL), and
each score within 1e-5 of the largest.  The masks agree at every coordinate whose score is not within
twice the largest score difference of the cut; those that close to it
are at most 5% of the coordinates, so that a test cannot pass by
counting every coordinate as a tie.  SynFlow is held
round by round along JAX's trajectory (the port's round on the masks
JAX scored under): two f32 roundings of a score at a round's cut can
prune different coordinates, and every later round scores the network
that is left, so two whole runs' kept sets overlap rather than agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.baselines import pruning as jpruning
from uvc_tpu.models import vit as jvit
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.baselines import pruning as tpruning
from uvc_tpu_torch.interop import params_from_numpy
from uvc_tpu_torch.models import vit as tvit

TOL = 1e-5
# SynFlow's scores come through the |w|-linearised network, every block's
# products compounding: along 100 rounds of JAX's trajectory the worst
# leaf of one round is at 1.09e-5 (the next 9.6e-6), so its per-leaf
# bound is 2e-5
SYNFLOW_TOL = 2e-5
KW = dict(name="scorers", img_size=32, patch_size=8, embed_dim=16,
          depth=2, num_heads=4, num_classes=10)
JCFG = jconfigs.ViTConfig(**KW)
TCFG = tconfigs.ViTConfig(**KW)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(seed):
    """Trained-looking weights: every kernel and bias drawn, the head
    too (a zero head makes every gradient score zero)."""
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gating" in name or "scale" in name:
            return leaf
        std = 0.3 if "bias" in name else 0.2
        return jnp.asarray(std * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def batches(n, seed=5, b=6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def jloss(p, x, y):
    out = jvit.apply(p, x, JCFG, train=True)
    logp = jax.nn.log_softmax(out.logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))


def tloss(p, x, y):
    out = tvit.apply(p, x, TCFG, train=True, dtype=torch.float32)
    return -torch.log_softmax(out.logits, dim=-1).gather(-1, y[:, None]).mean()


def jforward_sum(p):
    ones = jnp.ones((1, 32, 32, 3))
    return jnp.sum(jvit.apply(p, ones, JCFG, train=False).logits)


def tforward_sum(p):
    ones = torch.ones(1, 32, 32, 3)
    return tvit.apply(p, ones, TCFG, train=False,
                      dtype=torch.float32).logits.sum()


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def flat(masks_or_scores, params):
    return jpruning.masks_to_flat(masks_or_scores, params)


def global_cut(jflat, density):
    allv = np.concatenate([v.ravel() for v in jflat.values()])
    k = int((1.0 - density) * allv.size)
    return np.sort(allv)[k - 1]


def compare_scores(tscores, jscores, params, tol=TOL):
    jf, tf = flat(jscores, params), tpruning.masks_to_flat(tscores)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert rel_fro(tf[k], jf[k]) <= tol, k
    return jf, tf


def near_cut_mismatches(tmasks, jmasks, jf, tf, params, cut, leaves):
    """(coordinates near the cut whose two scores differ, coordinates
    masked differently) over each group of ``leaves`` that shares a cut
    (``cut`` one number, or one per leaf).  With every score within
    ``delta`` of JAX's, the k-th value moves by at most ``delta`` too, so
    a coordinate can be masked differently only within ``2 delta`` of
    the cut: every mismatch must be there, ``delta`` at most 1e-5 of the
    group's largest score, and the coordinates there few."""
    jm, tm = flat(jmasks, params), tpruning.masks_to_flat(tmasks)
    assert sorted(jm) == sorted(tm)
    near_total = diff_total = 0
    for group in leaves:
        delta = max(float(np.abs(tf[k] - jf[k]).max()) for k in group)
        assert delta <= TOL * max(float(jf[k].max()) for k in group)
        for k in group:
            cut_k = cut[k] if isinstance(cut, dict) else cut
            near = (np.abs(jf[k] - cut_k) <= 2 * delta) & (jf[k] != tf[k])
            diff = tm[k] != jm[k]
            assert not (diff & ~near).any(), k
            near_total += int(near.sum())
            diff_total += int(diff.sum())
    assert near_total <= 0.05 * sum(v.size for v in jf.values())
    return near_total, diff_total


def global_near(tm, jm, jf, tf, params, density):
    return near_cut_mismatches(tm, jm, jf, tf, params,
                               global_cut(jf, density), [list(jf)])


def test_tree_grad_matches_jax_grad():
    params = jax_params(0)
    tp = params_from_numpy(np_tree(params), device="cpu")
    (x, y), = batches(1)
    jg = jax.grad(jloss)(params, jnp.asarray(x), jnp.asarray(y))
    tg = tpruning.tree_grad(tloss, tp, torch.from_numpy(x),
                            torch.from_numpy(y).long())
    from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path
    for path, g in tree_leaves_with_path(tg):
        ref = np.asarray(leaf_at(jg, path))
        if not ref.any():
            # leaves the forward does not read: exact zeros, as jax.grad
            assert not g.any(), path
            continue
        assert rel_fro(g.numpy(), ref) <= TOL, path


@pytest.mark.parametrize("scope", ["global", "local"])
def test_taylor_scores_and_masks_match_jax(scope):
    params = jax_params(1)
    tp = params_from_numpy(np_tree(params), device="cpu")
    data = batches(3)
    jscores = jpruning.taylor_scores(
        params, jloss, [(jnp.asarray(x), jnp.asarray(y)) for x, y in data])
    tscores = tpruning.taylor_scores(
        tp, tloss, [(torch.from_numpy(x), torch.from_numpy(y).long())
                    for x, y in data])
    jf, tf = compare_scores(tscores, jscores, params)
    fn = f"{scope}_threshold_mask"
    jm = getattr(jpruning, fn)(jscores, 0.5)
    tm = getattr(tpruning, fn)(tscores, 0.5)
    if scope == "global":
        near, diff = global_near(tm, jm, jf, tf, params, 0.5)
    else:
        cut = {k: np.sort(v.ravel())[int(0.5 * v.size) - 1]
               for k, v in jf.items()}
        near, diff = near_cut_mismatches(tm, jm, jf, tf, params, cut,
                                         [[k] for k in jf])
    assert diff <= near
    assert tpruning.mask_sparsity(tm) == pytest.approx(
        jpruning.mask_sparsity(jm), abs=2 / sum(v.size for v in jf.values()))


def test_taylor_accumulates_without_zeroing():
    """Scoring the same batch twice doubles every score (the gradients
    add up; nothing is zeroed between batches)."""
    params = jax_params(2)
    tp = params_from_numpy(np_tree(params), device="cpu")
    (x, y), = batches(1)
    b = (torch.from_numpy(x), torch.from_numpy(y).long())
    once = tpruning.masks_to_flat(tpruning.taylor_scores(tp, tloss, [b]))
    twice = tpruning.masks_to_flat(tpruning.taylor_scores(tp, tloss, [b, b]))
    for k in once:
        np.testing.assert_allclose(twice[k], 2 * once[k], rtol=1e-6,
                                   atol=0)


def jax_synflow_trajectory(params, density, epochs):
    """JAX's ``synflow_scores`` loop, yielding each round's (masks it
    scored under, scores, new masks)."""
    jabs = jax.tree.map(jnp.abs, params)
    grad_fn = jax.jit(jax.grad(
        lambda p, m: jforward_sum(jpruning.apply_weight_masks(p, m))))
    masks = jpruning.identity_masks(params)
    for epoch in range(epochs):
        g = grad_fn(jabs, masks)
        scores = jpruning._map_maskable(lambda w, gg: jnp.abs(gg * w),
                                        jabs, g)
        new = jpruning.global_threshold_mask(
            scores, density ** ((epoch + 1) / epochs))
        yield masks, scores, new
        masks = new


@pytest.mark.parametrize("epochs", [3, 100])
def test_synflow_rounds_match_jax(epochs):
    """Every round of JAX's SynFlow trajectory: the port's round on the
    masks JAX scored under gives JAX's scores and, thresholded, JAX's
    masks; the port's whole ``synflow_scores`` then hits the density, and
    over 3 rounds keeps JAX's set."""
    from uvc_tpu_torch.interop import wmasks_from_numpy
    from uvc_tpu_torch.utils.tree import tree_map
    params = jax_params(3)
    tp = params_from_numpy(np_tree(params), device="cpu")
    tabs = tree_map(torch.abs, tp)
    density = 0.3
    near_total = 0
    for epoch, (jmasks, jscores, jnew) in enumerate(
            jax_synflow_trajectory(params, density, epochs)):
        tscores = tpruning.synflow_round(
            tabs, wmasks_from_numpy(np_tree(jmasks), device="cpu"),
            tforward_sum)
        jf, tf = compare_scores(tscores, jscores, params, SYNFLOW_TOL)
        d = density ** ((epoch + 1) / epochs)
        near, _ = global_near(tpruning.global_threshold_mask(tscores, d),
                              jnew, jf, tf, params, d)
        near_total += near
    # the trajectory is JAX's own function's
    ref_scores, ref_masks = jpruning.synflow_scores(params, jforward_sum,
                                                    density, epochs=epochs)
    for a, b in ((jscores, ref_scores), (jnew, ref_masks)):
        fa, fb = flat(a, params), flat(b, params)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    print(f"synflow {epochs} rounds: {near_total} coordinates at a "
          f"round's cut")

    _, tm = tpruning.synflow_scores(tp, tforward_sum, density,
                                    epochs=epochs)
    jflat, tflat = flat(ref_masks, params), tpruning.masks_to_flat(tm)
    total = sum(v.size for v in jflat.values())
    assert abs(tpruning.mask_sparsity(tm) - density) <= 2 / total
    both = sum(int((jflat[k] * tflat[k]).sum()) for k in jflat)
    either = sum(int(np.maximum(jflat[k], tflat[k]).sum()) for k in jflat)
    print(f"synflow {epochs} rounds: kept sets' Jaccard {both / either:.4f}")
    if epochs == 3:
        assert both / either >= 0.99
    # at 100 rounds the two runs part at the first coordinate that one
    # rounding keeps and the other prunes (round 8 here), and their kept
    # sets end up overlapping by about half: the rounds above, on the
    # same masks, are what agrees


def _sp_scores(params, grads):
    """The SP head and unit scores in numpy (the quantities the masks
    rank)."""
    l, h, hs, d = JCFG.depth, JCFG.num_heads, JCFG.head_size, JCFG.embed_dim
    w = np.asarray(params["blocks"]["qkv"]["kernel"])[:, :, 2 * d:]
    g = np.asarray(grads["blocks"]["qkv"]["kernel"])[:, :, 2 * d:]
    heads = np.abs((w * g).reshape(l, d, h, hs).sum(axis=(1, 3)))
    chan = (np.abs(np.asarray(grads["blocks"]["fc1"]["kernel"])).sum(1)
            + np.abs(np.asarray(grads["blocks"]["fc2"]["kernel"])).sum(2))
    return heads, chan


@pytest.mark.parametrize("densities", [(0.5, 0.5), (0.25, 0.7), (0.0, 0.01)])
def test_sp_structured_masks_match_jax(densities):
    params = jax_params(4)
    tp = params_from_numpy(np_tree(params), device="cpu")
    (x, y), = batches(1, seed=9)
    jg = jax.grad(jloss)(params, jnp.asarray(x), jnp.asarray(y))
    tg = tpruning.tree_grad(tloss, tp, torch.from_numpy(x),
                            torch.from_numpy(y).long())
    js = jpruning.sp_structured_masks(params, jg, JCFG, *densities)
    ts = tpruning.sp_structured_masks(tp, tg, TCFG, *densities)
    near = 0
    for kind, scores in zip(("attn", "mlp"), _sp_scores(params, jg)):
        jmask, tmask = np.asarray(js[kind]), ts[kind].numpy()
        keep = jmask.sum(axis=1)
        assert (tmask.sum(axis=1) == keep).all()
        # a row's cut: the smallest kept score and the largest dropped one
        for row in range(scores.shape[0]):
            s = scores[row]
            lo = s[jmask[row] == 1].min()
            hi = s[jmask[row] == 0].max() if (jmask[row] == 0).any() else -1
            close = abs(lo - hi) <= TOL * abs(lo)
            near += int(close)
            if not close:
                np.testing.assert_array_equal(tmask[row], jmask[row])
    assert near == 0
    # the weight masks they expand to
    jw = jpruning.head_masks_to_weight_masks(js["attn"], js["mlp"], params,
                                             JCFG)
    tw = tpruning.head_masks_to_weight_masks(ts["attn"], ts["mlp"], tp, TCFG)
    jflat, tflat = flat(jw, params), tpruning.masks_to_flat(tw)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


def test_sp_ranks_tied_scores_as_jax():
    """Tied scores (all zero, and runs of equal values) rank by a stable
    argsort, as JAX's: the same heads and units are kept."""
    params = jax_params(5)
    tp = params_from_numpy(np_tree(params), device="cpu")
    zeros = jax.tree.map(jnp.zeros_like, params)
    rng = np.random.default_rng(6)
    fc1 = np.repeat(rng.integers(0, 3, (JCFG.depth, 1, JCFG.mlp_hidden // 4))
                    .astype(np.float32), 4, axis=2)
    fc1 = np.broadcast_to(fc1, (JCFG.depth, JCFG.embed_dim, JCFG.mlp_hidden))
    grads = jax.tree.map(lambda a: a, zeros)
    grads["blocks"]["fc1"]["kernel"] = jnp.asarray(fc1)
    for dens in ((0.5, 0.5), (0.75, 0.3)):
        js = jpruning.sp_structured_masks(params, grads, JCFG, *dens)
        ts = tpruning.sp_structured_masks(
            tp, params_from_numpy(np_tree(grads), device="cpu"), TCFG, *dens)
        for kind in ("attn", "mlp"):
            np.testing.assert_array_equal(ts[kind].numpy(),
                                          np.asarray(js[kind]))
    # an unstable argsort would not promise this: every head ties, and
    # the last ones are kept
    assert ts["attn"][:, -3:].all() and not ts["attn"][:, 0].any()


def test_head_masks_to_weight_masks_match_jax():
    params = jax_params(6)
    tp = params_from_numpy(np_tree(params), device="cpu")
    rng = np.random.default_rng(7)
    head = (rng.random((JCFG.depth, JCFG.num_heads)) > 0.5).astype(np.float32)
    mlp = (rng.random((JCFG.depth, JCFG.mlp_hidden)) > 0.5).astype(np.float32)
    jw = jpruning.head_masks_to_weight_masks(jnp.asarray(head),
                                             jnp.asarray(mlp), params, JCFG)
    tw = tpruning.head_masks_to_weight_masks(torch.from_numpy(head),
                                             torch.from_numpy(mlp), tp, TCFG)
    jflat, tflat = flat(jw, params), tpruning.masks_to_flat(tw)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert tflat[k].dtype == np.float32
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    # a pruned head zeroes its q, k and v columns; a pruned unit its fc1
    # column and fc2 row
    qkv = tflat["blocks.qkv.kernel"]
    hs, d = JCFG.head_size, JCFG.embed_dim
    for layer in range(JCFG.depth):
        for h in range(JCFG.num_heads):
            for part in range(3):
                cols = qkv[layer, :, part * d + h * hs:part * d + (h + 1) * hs]
                assert (cols == head[layer, h]).all()
    assert (tflat["blocks.fc2.kernel"][:, :, 0] == mlp).all()


def test_masks_from_flat_refuses_a_mismatched_shape():
    params = jax_params(7)
    tp = params_from_numpy(np_tree(params), device="cpu")
    masks = tpruning.masks_to_flat(tpruning.identity_masks(tp))
    masks["head.kernel"] = np.ones((JCFG.embed_dim, 3), np.float32)
    with pytest.raises(ValueError, match="head.kernel"):
        tpruning.masks_from_flat(masks, tp)
