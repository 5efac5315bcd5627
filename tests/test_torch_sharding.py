"""Port parity, the LM sharding plan: ``repro_torch.parallel.sharding``
against the reference's ``parallel/sharding.py`` on the shape-only
``{"data": 16, "model": 16}`` and ``{"pod": 2, "data": 16, "model": 16}``
meshes (no process group, no device, no JAX compile: the reference's
``eval_shape`` and the port's ``meta`` trees).

For every arch: ``choose_attn_mode`` for training and decode, and
``param_specs``, ``opt_specs``, ``batch_spec`` and ``cache_specs`` of a
128 x 32768 decode cache, leaf by leaf by path.  Then the reference's
pinned cases (``tests/test_sharding.py``) and the port's own: DTensor
``placements`` of a spec over a named mesh.
"""

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as RP

from repro.configs import ARCHS as R_ARCHS
from repro.models import LM as R_LM
from repro.parallel.sharding import choose_attn_mode as r_choose
from repro.parallel.sharding import make_plan as r_make_plan

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCHS
from repro_torch.models import LM
from repro_torch.parallel.sharding import P, choose_attn_mode, is_spec, make_plan, placements
from repro_torch.tree import flatten_with_path

CACHE = (128, 32768)


class _FakeMesh:
    """Shape-only stand-in so plan rules can be tested without devices."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


FAKE = _FakeMesh({"data": 16, "model": 16})
FAKE_MULTI = _FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": FAKE, "2x16x16": FAKE_MULTI}


@functools.lru_cache(maxsize=None)
def _abstract(name):
    """(reference params, reference cache, port params, port cache), shapes only."""
    r_lm, t_lm = R_LM(R_ARCHS[name]), LM(ARCHS[name])
    return (r_lm.abstract_params(), r_lm.abstract_cache(*CACHE),
            t_lm.abstract_params(), t_lm.abstract_cache(*CACHE))


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                    for p in path)


def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, RP))
    return {_key(path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    return {"/".join(str(k) for k in path): tuple(spec)
            for path, spec in flatten_with_path(tree, is_leaf=is_spec)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_plan_equals_the_reference(name, mesh_name):
    mesh = MESHES[mesh_name]
    r_params, r_cache, t_params, t_cache = _abstract(name)
    for kind in ("train", "decode"):
        assert choose_attn_mode(ARCHS[name], mesh, kind) == r_choose(R_ARCHS[name], mesh, kind)
    plan, r_plan = make_plan(ARCHS[name], mesh), r_make_plan(R_ARCHS[name], mesh)
    assert plan.attn_mode == r_plan.attn_mode
    got, want = _port_specs(plan.param_specs(t_params)), _ref_specs(r_plan.param_specs(r_params))
    assert got == want
    got, want = _port_specs(plan.opt_specs(t_params)), _ref_specs(r_plan.opt_specs(r_params))
    assert got == want
    for ndim in (2, 3):
        assert tuple(plan.batch_spec(ndim)) == tuple(r_plan.batch_spec(ndim))
    decode, r_decode = (make_plan(ARCHS[name], mesh, kind="decode"),
                        r_make_plan(R_ARCHS[name], mesh, kind="decode"))
    got, want = _port_specs(decode.cache_specs(t_cache)), _ref_specs(r_decode.cache_specs(r_cache))
    assert got == want


# -- the reference's pinned cases (tests/test_sharding.py) ---------------------------


def _specs(name, mesh=FAKE, **kw):
    return make_plan(ARCHS[name], mesh, **kw).param_specs(_abstract(name)[2])


def test_attn_mode_selection():
    assert choose_attn_mode(ARCHS["deepseek-moe-16b"], FAKE) == "heads"
    assert choose_attn_mode(ARCHS["qwen2-moe-a2.7b"], FAKE) == "heads"
    assert choose_attn_mode(ARCHS["glm4-9b"], FAKE) == "qheads"      # Hg=16
    assert choose_attn_mode(ARCHS["gemma-2b"], FAKE) == "seq"        # MQA
    assert choose_attn_mode(ARCHS["gemma-2b"], FAKE, "decode") == "head_dim"
    assert choose_attn_mode(ARCHS["starcoder2-7b"], FAKE) == "seq"   # Hg=9


def test_gemma_embed_mlp_and_seq_mode():
    specs = _specs("gemma-2b")
    assert specs["embed"]["table"] == P("model", None)
    blk = specs["blocks"]["0:dense"]
    assert blk["mlp"]["w_gate"] == P(None, None, "model")
    assert blk["mlp"]["w_down"] == P(None, "model", None)
    # 'seq' plan: no model-axis TP on attention; FSDP shards D over 'data'
    assert blk["attn"]["wq"] == P(None, "data", None, None, None)


def test_gemma_decode_head_dim_mode():
    blk = _specs("gemma-2b", kind="decode")["blocks"]["0:dense"]["attn"]
    assert blk["wq"] == P(None, None, None, None, "model")
    assert blk["wo"] == P(None, None, None, "model", None)


def test_deepseek_expert_parallel():
    specs = _specs("deepseek-moe-16b")
    moe = specs["blocks"]["0:moe"]["moe"]
    assert moe["w_gate"] == P(None, "model", None, None)   # 64 experts / 16
    assert moe["w_down"] == P(None, "model", None, None)
    assert specs["blocks"]["0:moe"]["attn"]["wq"] == P(None, None, "model", None, None)


def test_qwen2_expert_fallback_shards_f():
    moe = _specs("qwen2-moe-a2.7b")["blocks"]["0:moe"]["moe"]
    assert moe["w_gate"] == P(None, None, None, "model")    # 60 experts; F=1408 % 16 == 0
    assert moe["w_down"] == P(None, None, "model", None)


def test_hymba_odd_vocab_falls_back_to_data():
    assert _specs("hymba-1.5b")["embed"]["table"] == P(None, "data")


def test_zero1_adds_data_axis():
    ospecs = make_plan(ARCHS["gemma-2b"], FAKE).opt_specs(_abstract("gemma-2b")[2])
    assert ospecs["m"]["embed"]["table"] == P("model", "data")
    assert ospecs["count"] == P()


def test_cache_specs_shard_long_sequences():
    plan = make_plan(ARCHS["gemma3-12b"], FAKE, kind="decode")
    specs = plan.cache_specs(_abstract("gemma3-12b")[3])
    assert specs["blocks"]["0:local"]["k"] == P(None, "data", None, None, None)  # ring of 1024
    assert specs["blocks"]["5:global"]["k"] == P(None, "data", "model", None, None)


def test_multipod_batch_spec():
    assert make_plan(ARCHS["gemma-2b"], FAKE_MULTI).batch_spec(2) == P(("pod", "data"), None)


# -- DTensor placements -------------------------------------------------------------


class _NamedMesh:
    """What ``placements`` reads of a ``DeviceMesh``: its dim names and sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def test_placements_of_a_spec():
    mesh = _NamedMesh(pod=2, data=16, model=16)
    assert placements(P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, None), mesh) == (Replicate(),) * 3
    assert placements(P(None, "data"), _NamedMesh(data=2, model=2)) == (Shard(1), Replicate())
    # a 1-wide mesh dim holds the whole tensor
    assert placements(P("data", "model"), _NamedMesh(data=1, model=2)) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(P("model", "model"), mesh)
