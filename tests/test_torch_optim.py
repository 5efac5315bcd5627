"""Port parity, the optimizer: ``repro_torch.optim`` against the
reference's ``optim`` on the same numpy-made trees, then twins of
``tests/test_optim.py``.

Tolerances, each with its reason:

- ``compress``/``decompress`` and the carried error: bitwise.  Every
  step is one float32 operation of the same operands (the max, a divide by
  127, a round half to even, a multiply, a subtract).
- AdamW state after 3 steps, ``global_norm`` and ``schedule_lr``:
  relative 2e-6 (a few float32 ulps).  ``global_norm`` sums each leaf in
  another order than XLA; ``pow`` and ``cos`` are other float32
  implementations; the update divides by ``sqrt(v)``, which keeps the
  relative error of its operands.
- The leaf order of :func:`repro_torch.tree.flatten_with_path`: exactly
  JAX's, path for path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.configs import ARCHS as R_ARCHS

from repro_torch import optim as T
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import LM
from repro_torch.optim.adamw import _decay_mask
from repro_torch.tree import flatten_with_path, leaves, tree_map

RTOL = 2e-6


def _tree(rng, n_sb=3, H=4, D=8):
    """A parameter tree with stacked superblock leaves, an unrolled prefix
    tuple and decay-named leaves, its dicts in unsorted key order."""
    def layer(*lead):
        return {
            "ln": {"scale": rng.standard_normal((*lead, D))},
            "w_up": rng.standard_normal((*lead, D, 2 * D)),
            "b_gates": rng.standard_normal((*lead, 2 * H)),
            "mix_beta": rng.standard_normal((*lead, 2)),
            "ssm_a_log": rng.standard_normal((*lead, H)),
            "attn": {"wq": rng.standard_normal((*lead, D, 2, 2, 4)),
                     "wo": rng.standard_normal((*lead, 2, 2, 4, D))},
        }
    tree = {
        "final_norm": {"scale": rng.standard_normal((D,))},
        "embed": {"table": rng.standard_normal((16, D))},
        "prefix": (layer(), layer()),
        "blocks": {"1:hymba": layer(n_sb), "0:dense": layer(n_sb)},
        "meta": rng.standard_normal((4, D)),
    }
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(a), tree)


def _jax(tree):
    return tree_map(lambda a: jnp.asarray(a), tree)


def _close(got, want, rtol=RTOL, what=""):
    got = [np.asarray(g) for g in leaves(tree_map(lambda t: t.numpy(), got))]
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rtol * scale, what


def test_flatten_order_is_jax_order():
    """Every leaf path of a config's parameters (dicts, the prefix tuple)
    in JAX's flatten order."""
    params = LM(reduced(ARCHS["deepseek-moe-16b"])).init(torch.Generator().manual_seed(0))
    ref = jax.tree_util.tree_flatten_with_path(tree_map(lambda t: t.numpy(), params))[0]
    want = [tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path) for path, _ in ref]
    assert [path for path, _ in flatten_with_path(params)] == want
    assert R_ARCHS["deepseek-moe-16b"].prefix_pattern   # the tuple is exercised


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2, warmup_steps=2, total_steps=5),                       # cosine, warmup
    dict(lr=1e-2, schedule="constant", warmup_steps=0, weight_decay=0.0),
    dict(lr=3e-3, clip_norm=0.5, warmup_steps=1, total_steps=3, min_lr_ratio=0.0),
], ids=["cosine", "constant-no-decay", "clipped"])
def test_adamw_three_steps_match_the_reference(cfg):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [tree_map(lambda a, s=s: a * s, _tree(rng)) for s in (1.0, 0.3, 2.0)]
    ocfg_t, ocfg_r = T.AdamWConfig(**cfg), R.AdamWConfig(**cfg)
    tp = _torch(p0)
    ts = T.init_opt_state(tp)
    rp = _jax(p0)
    rs = R.init_opt_state(rp)
    for g in grads:
        tp2, ts2, tm = T.adamw_update(ocfg_t, tp, _torch(g), ts)
        assert tp2 is tp and ts2 is ts          # in place
        rp, rs, rm = R.adamw_update(ocfg_r, rp, _jax(g), rs)
        for k in ("lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=RTOL, err_msg=k)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == int(rs["count"]) == 3
    _close(tp, rp, what="params")
    _close(ts["m"], rs["m"], what="m")
    _close(ts["v"], rs["v"], what="v")


def test_schedule_lr_matches_the_reference():
    for kw in (dict(), dict(schedule="constant", warmup_steps=7),
               dict(warmup_steps=10, total_steps=110, min_lr_ratio=0.1)):
        t, r = T.AdamWConfig(**kw), R.AdamWConfig(**kw)
        for step in (0, 1, 5, 10, 99, 100, 101, 5000, 9999, 10_000, 20_000):
            got = T.schedule_lr(t, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(R.schedule_lr(r, jnp.asarray(step))),
                                       rtol=RTOL)


def test_global_norm_matches_the_reference():
    tree = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(T.global_norm(_torch(tree))),
                               float(R.global_norm(_jax(tree))), rtol=RTOL)


def _no_tuple(tree):
    """The reference's ``compress`` picks the (q, scale) pairs with
    ``is_leaf=isinstance(t, tuple)``, which also catches a tuple of the
    tree itself (the ``prefix`` layers): see the test after this one."""
    return {k: v for k, v in tree.items() if k != "prefix"}


def test_compression_with_carried_error_is_bitwise():
    rng = np.random.default_rng(2)
    p0 = _no_tuple(_tree(rng))
    t_err, r_err = T.init_error_state(_torch(p0)), R.init_error_state(_jax(p0))
    for scale in (1.0, 1e-3, 50.0):
        g = tree_map(lambda a: a * np.float32(scale), _no_tuple(_tree(rng)))
        t_comp, t_err = T.compress(_torch(g), t_err)
        r_comp, r_err = R.compress(_jax(g), r_err)
        for got, want in ((t_comp["q"], r_comp["q"]), (t_comp["scale"], r_comp["scale"]),
                          (t_err, r_err), (T.decompress(t_comp), R.decompress(r_comp))):
            g_leaves = [t.numpy() for t in leaves(got)]
            w_leaves = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
            for a, b in zip(g_leaves, w_leaves):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_compression_keeps_a_prefix_tuple():
    """A reference fault the port does not keep: ``repro``'s ``compress``
    takes the ``prefix`` tuple of a tree (deepseek-moe-16b's dense layer)
    for a (q, scale) pair, so its ``compress`` of such a tree raises.
    The port quantises the prefix's leaves like any other."""
    rng = np.random.default_rng(4)
    g = _tree(rng)
    comp, err = T.compress(_torch(g), T.init_error_state(_torch(g)))
    deq = T.decompress(comp)
    assert comp["q"]["prefix"][1]["w_up"].dtype == torch.int8
    for (path, d), (_, want), (_, e) in zip(flatten_with_path(deq), flatten_with_path(g),
                                            flatten_with_path(err)):
        np.testing.assert_array_equal((d + e).numpy(), want, err_msg=str(path))
    with pytest.raises(ValueError):
        R.compress(_jax(g), R.init_error_state(_jax(g)))


def test_decay_mask_quirk_is_kept():
    """A stacked 1-D gate or bias not named as excluded decays inside
    ``blocks`` but not in the unrolled ``prefix`` tuple, in both packages;
    ``b_``/``ln``/``scale`` names never decay."""
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    zero = tree_map(np.zeros_like, p0)
    cfg = dict(lr=0.1, warmup_steps=0, schedule="constant", weight_decay=0.5)
    tp = _torch(p0)
    T.adamw_update(T.AdamWConfig(**cfg), tp, _torch(zero), T.init_opt_state(tp))
    rp, _, _ = R.adamw_update(R.AdamWConfig(**cfg), _jax(p0), _jax(zero),
                              R.init_opt_state(_jax(p0)))
    _close(tp, rp)
    decayed = {path: not np.array_equal(t.numpy(), p)
               for (path, t), (_, p) in zip(flatten_with_path(tp), flatten_with_path(p0))}
    assert decayed[("blocks", "1:hymba", "mix_beta")]
    assert decayed[("blocks", "1:hymba", "ssm_a_log")]
    assert not decayed[("prefix", 0, "mix_beta")]
    assert not decayed[("prefix", 1, "ssm_a_log")]
    assert not decayed[("blocks", "0:dense", "b_gates")]
    assert not decayed[("blocks", "0:dense", "ln", "scale")]
    assert decayed[("prefix", 0, "w_up")] and decayed[("meta",)]
    assert not _decay_mask(("final_norm", "scale"), torch.zeros(3, 3))


# -- twins of tests/test_optim.py ------------------------------------------------


def _params():
    return {
        "w_up": torch.ones((4, 8)) * 0.5,
        "ln": {"scale": torch.zeros((8,))},
    }


def test_adamw_moves_against_gradient():
    p = _params()
    w0 = float(p["w_up"][0, 0])
    g = tree_map(torch.ones_like, p)
    st = T.init_opt_state(p)
    cfg = T.AdamWConfig(lr=0.1, warmup_steps=0, schedule="constant", weight_decay=0.0)
    p2, st2, m = T.adamw_update(cfg, p, g, st)
    assert float(p2["w_up"][0, 0]) < w0
    assert int(st2["count"]) == 1
    assert float(m["lr"]) == pytest.approx(0.1)


def test_weight_decay_only_on_matrices():
    p = _params()
    g = tree_map(torch.zeros_like, p)
    st = T.init_opt_state(p)
    cfg = T.AdamWConfig(lr=0.1, warmup_steps=0, schedule="constant", weight_decay=0.5)
    p2, _, _ = T.adamw_update(cfg, p, g, st)
    assert float(p2["w_up"].abs().max()) < 0.5
    np.testing.assert_array_equal(p2["ln"]["scale"].numpy(), 0.0)


def test_grad_clipping():
    p = {"w": torch.zeros((4, 4))}
    g = {"w": torch.full((4, 4), 100.0)}
    st = T.init_opt_state(p)
    cfg = T.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, schedule="constant")
    _, _, m = T.adamw_update(cfg, p, g, st)
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    assert float(m["clip_scale"]) == pytest.approx(1.0 / 400.0)


def test_schedule_warmup_and_cosine():
    cfg = T.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(T.schedule_lr(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(T.schedule_lr(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(T.schedule_lr(cfg, torch.tensor(10))) == pytest.approx(1.0)
    end = float(T.schedule_lr(cfg, torch.tensor(110)))
    assert end == pytest.approx(0.1, rel=1e-3)


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.ones((4,)) * 2}
    assert float(T.global_norm(t)) == pytest.approx(np.sqrt(3 + 16))


def test_compression_error_feedback_roundtrip():
    rng = np.random.default_rng(0)
    g = {"w": torch.tensor(rng.standard_normal((32, 32)).astype(np.float32))}
    err = T.init_error_state(g)
    comp, err2 = T.compress(g, err)
    deq = T.decompress(comp)
    assert comp["q"]["w"].dtype == torch.int8
    scale = float(comp["scale"]["w"])
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose(err2["w"].numpy(), (g["w"] - deq["w"]).numpy(), atol=1e-6)
    comp2, err3 = T.compress(g, err2)
    deq2 = T.decompress(comp2)
    total = (deq["w"] + deq2["w"]).numpy()
    np.testing.assert_allclose(total, 2 * g["w"].numpy(), atol=2.1 * scale)
