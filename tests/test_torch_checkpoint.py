"""Port parity, checkpoints and crash-restart: ``repro_torch.checkpoint``
and ``runtime.resume_or_init`` on the reference's on-disk layout, bitwise
both ways (a ``repro`` checkpoint restored by the port and a port
checkpoint restored by ``repro``, float32 and int32 leaves, a config's
whole training state with its prefix tuple); then twins of
``tests/test_checkpoint.py`` and of the resume tests of
``tests/test_fault_tolerance.py``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCheckpointer

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import LM
from repro_torch.optim import init_opt_state
from repro_torch.runtime import resume_or_init
from repro_torch.tree import flatten_with_path, leaves, tree_map


def _state(seed):
    """A training state of reduced deepseek-moe-16b (dense prefix tuple,
    stacked MoE leaves): float32 params and moments, an int32 count."""
    params = LM(reduced(ARCHS["deepseek-moe-16b"])).init(torch.Generator().manual_seed(seed))
    opt = init_opt_state(params)
    opt["m"] = tree_map(lambda t: t + 0.5, params)
    opt["count"] = torch.tensor(17, dtype=torch.int32)
    return {"params": params, "opt": opt}


def _assert_trees_equal(got, want):
    got = [(p, np.asarray(v)) for p, v in flatten_with_path(tree_map(_np, got))]
    want = [(p, np.asarray(v)) for p, v in flatten_with_path(tree_map(_np, want))]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    src = _state(0)
    RCheckpointer(str(tmp_path)).save(5, tree_map(lambda t: jnp.asarray(t.numpy()), src))
    like = _state(1)
    step, got = Checkpointer(str(tmp_path)).restore_latest(like)
    assert step == 5
    _assert_trees_equal(got, src)
    assert got["opt"]["count"] is like["opt"]["count"]       # in place, into `like`
    assert got["opt"]["count"].dtype == torch.int32


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    src = _state(2)
    Checkpointer(str(tmp_path)).save(8, src)
    like = tree_map(lambda t: np.zeros_like(t.numpy()), src)
    step, got = RCheckpointer(str(tmp_path)).restore_latest(like)
    assert step == 8
    _assert_trees_equal(got, src)
    ours = json.load(open(tmp_path / "step_8" / "manifest.json"))
    d = tmp_path / "ref"
    RCheckpointer(str(d)).save(8, tree_map(lambda t: jnp.asarray(t.numpy()), src))
    theirs = json.load(open(d / "step_8" / "manifest.json"))
    assert ours["leaves"] == theirs["leaves"]                 # keys, order, shapes, dtypes


def test_bf16_leaf_is_stored_as_the_reference_stores_it(tmp_path):
    """The reference writes a bf16 leaf as numpy's raw 2-byte void (``V2``)
    with ``bfloat16`` in the manifest, which plain numpy reads back; the
    port writes the same bytes and restores them as bf16 (the reference
    cannot restore them)."""
    x = torch.tensor([[1.5, -2.25, 3e-3], [0.0, 7.0, -1e4]], dtype=torch.bfloat16)
    Checkpointer(str(tmp_path / "t")).save(1, {"w": x})
    RCheckpointer(str(tmp_path / "r")).save(1, {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    arrays = {}
    for side in ("t", "r"):
        with np.load(tmp_path / side / "step_1" / "arrays.npz") as data:
            arrays[side] = data["a0"]
        manifest = json.load(open(tmp_path / side / "step_1" / "manifest.json"))
        assert manifest["leaves"][0]["dtype"] == "bfloat16"
    assert arrays["t"].dtype == arrays["r"].dtype == np.dtype("V2")
    assert arrays["t"].shape == arrays["r"].shape and arrays["t"].tobytes() == arrays["r"].tobytes()
    for side in ("t", "r"):
        like = {"w": torch.zeros_like(x)}
        step, got = Checkpointer(str(tmp_path / side)).restore_latest(like)
        assert step == 1 and torch.equal(got["w"], x)


def test_async_write_error_surfaces_at_wait(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    ck = Checkpointer(str(tmp_path))
    monkeypatch.setattr(ckpt_mod.np, "savez", broken)
    ck.save(3, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.committed_steps() == []
    ck.wait()                        # reported once


def test_save_snapshots_before_in_place_updates(tmp_path):
    ck = Checkpointer(str(tmp_path))
    w = torch.ones(4)
    ck.save(1, {"w": w}, blocking=False)
    w.add_(1.0)                      # the optimizer's in-place update
    ck.wait()
    _, got = ck.restore_latest({"w": torch.zeros(4)})
    np.testing.assert_array_equal(got["w"].numpy(), 1.0)


def test_mismatched_shape_raises_before_any_write(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2), "b": torch.ones(3)})
    like = {"a": torch.zeros(2), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="'b'"):
        ck.restore(1, like)
    assert float(like["a"].abs().sum()) == 0.0


def test_restore_keeps_like_dtypes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.full((2,), 1.25), "c": torch.tensor(3, dtype=torch.int32)})
    like = {"w": torch.zeros(2, dtype=torch.float64), "c": torch.zeros((), dtype=torch.int64)}
    _, got = ck.restore_latest(like)
    assert got["w"].dtype == torch.float64 and got["c"].dtype == torch.int64
    assert got["w"].tolist() == [1.25, 1.25] and int(got["c"]) == 3


# -- twins of tests/test_checkpoint.py --------------------------------------------


def _tree(x=1.0):
    return {
        "params": {"w": torch.full((4, 4), x), "b": torch.full((4,), 2 * x)},
        "opt": {"m": {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))},
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree(3.0)
    ck.save(10, t)
    step, t2 = ck.restore_latest(_tree(0.0))
    assert step == 10
    for a, b in zip(leaves(t), leaves(t2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0), blocking=False)
    ck.wait()
    assert ck.committed_steps() == [1]


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(float(s)))
    assert ck.committed_steps() == [3, 4]


def test_torn_checkpoint_ignored_and_fallback(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(5.0))
    ck.save(6, _tree(6.0))
    with open(os.path.join(str(tmp_path), "step_6", "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    step, t = ck.restore_latest(_tree())
    assert step == 5
    assert float(t["params"]["w"].reshape(-1)[0]) == 5.0


def test_tmp_dir_is_not_a_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert ck.committed_steps() == []
    assert ck.cleanup_tmp() == 1
    step, t = ck.restore_latest(_tree())
    assert step is None and t is None


def test_restore_mismatched_structure_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(1, {"just_one": torch.zeros((2,))})


# -- twins of the resume tests of tests/test_fault_tolerance.py -------------------


def _init():
    return {"params": {"w": torch.zeros((2, 2))},
            "opt": {"count": torch.tensor(0, dtype=torch.int32)}}


def test_resume_fresh_run(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = resume_or_init(ck, _init)
    assert st.step == 0 and not st.resumed


def test_resume_after_crash(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _init()
    tree["params"]["w"] = torch.full((2, 2), 9.0)
    ck.save(42, tree)
    os.makedirs(str(tmp_path) + "/step_43.tmp")
    st = resume_or_init(ck, _init)
    assert st.resumed and st.step == 42
    assert float(st.tree["params"]["w"][0, 0]) == 9.0
    assert not os.path.exists(str(tmp_path) + "/step_43.tmp")


def test_resume_into_a_given_template(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _init()
    tree["opt"]["count"] = torch.tensor(4, dtype=torch.int32)
    ck.save(4, tree)
    like = _init()
    st = resume_or_init(ck, lambda: pytest.fail("init on resume"), like=like)
    assert st.resumed and st.step == 4 and st.tree["opt"]["count"] is like["opt"]["count"]
    assert int(like["opt"]["count"]) == 4
