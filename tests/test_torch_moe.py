"""Port parity, the MoE FFN: ``repro_torch.models.moe`` against the
reference's ``models/moe.py`` on the same numpy-made inputs and the
reference's parameters; then deepseek-moe-16b (a dense first layer, then
MoE) and qwen2-moe through ``test_torch_lm_zoo``'s teacher-forced parity.

Routing is held exactly: the same top-k ids as ``jax.lax.top_k`` on the
same probabilities, tied logits included (ties go to the lower expert
id), and the same ``keep`` mask, i.e. the same capacity drops in token
order, as the reference's own lines compute it.  Outputs in float32
within 1e-5 (the same float32 math, summed in another order); the aux loss
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RMoEConfig
from repro.models import moe as r_moe

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import mlp
from repro_torch.models import moe as t_moe

from test_torch_lm_zoo import teacher_forced_parity

D, F = 32, 48


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(E=8, k=2, shared=1, cf=1.25):
    return (RMoEConfig(num_experts=E, top_k=k, num_shared=shared, capacity_factor=cf),
            MoEConfig(num_experts=E, top_k=k, num_shared=shared, capacity_factor=cf))


def _params(rmoe, mlp_type="swiglu"):
    p = r_moe.init_moe(jax.random.PRNGKey(7), D, F, rmoe, mlp_type)
    return p, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)


def _reference_keep(expert_ids, E, C):
    """The reference's position-in-expert and capacity mask, its own lines
    (``repro/models/moe.py:89-94``) on the given ids."""
    flat_ids = jnp.asarray(expert_ids).reshape(-1)
    onehot = jax.nn.one_hot(flat_ids, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=0) - 1
    pos = jnp.take_along_axis(pos_all, flat_ids[:, None], axis=1)[:, 0]
    return np.asarray(pos), np.asarray(pos < C)


def test_route_takes_the_reference_top_k_with_ties():
    """Integer logits with many exact ties: each row's top-k ids are
    ``jax.lax.top_k``'s (lower id first among equals), gate values
    renormalised alike."""
    rng = np.random.default_rng(501)
    logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)
    logits[0] = 1.0                       # a whole row tied
    logits[1, :4] = logits[1, 4:]         # pairs tied across the halves
    for k in (1, 2, 3, 6):
        probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        want_vals, want_ids = jax.lax.top_k(probs, k)
        want_vals = want_vals / jnp.maximum(want_vals.sum(-1, keepdims=True), 1e-9)
        got_probs, got_vals, got_ids = t_moe.route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(_np(got_vals), _np(want_vals), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(got_probs), _np(probs), rtol=1e-6, atol=1e-7)
    assert t_moe.route(torch.from_numpy(logits), 3)[2][0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("C", [1, 3, 5, 40])
def test_dispatch_keeps_what_the_reference_keeps(C):
    """Over-capacity choices dropped in token order: the same positions and
    ``keep`` mask as the reference's cumsum, with drops (C 1, 3, 5) and
    without (C 40)."""
    rng = np.random.default_rng(502)
    E, T, k = 8, 40, 2
    ids = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int64)
    ids[:10] = [0, 1]                      # a crowd on experts 0 and 1
    want_pos, want_keep = _reference_keep(ids, E, C)
    pos, keep = t_moe.dispatch(torch.from_numpy(ids), E, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (not want_keep.all()) == (C < 40)


def test_capacity_is_the_references_formula():
    for T, (E, k, cf) in [(40, (8, 2, 1.25)), (1024, (64, 6, 1.25)), (7, (60, 4, 1.25)),
                          (3, (8, 2, 4.0)), (1088, (64, 6, 64 / 6))]:
        _, moe = _configs(E, k, 0, cf)
        assert t_moe.capacity(T, moe, dropless=False) == int(max(1, round(T * k / E * cf)))
        assert t_moe.capacity(T, moe, dropless=True) == T
    # capacity_factor = E / top_k gives C = T: a dropless prefill
    _, moe = _configs(64, 6, 2, 64 / 6)
    assert t_moe.capacity(1088, moe, dropless=False) == 1088


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("shared,cf,dropless", [
    (1, 0.5, False), (1, 1.25, False), (0, 1.0, False), (2, 1.25, True),
])
def test_moe_ffn_matches_the_reference(mlp_type, shared, cf, dropless):
    """float32: capacity drops (cf 0.5 and 1.0 drop, asserted), the
    dropless decode path and the shared experts as one wide MLP."""
    rng = np.random.default_rng(503)
    rmoe, tmoe = _configs(8, 2, shared, cf)
    jp, tp = _params(rmoe, mlp_type)
    x = rng.standard_normal((3, 9, D)).astype(np.float32)
    want, want_aux = r_moe.moe_ffn(jp, jnp.asarray(x), rmoe, mlp_type, dropless=dropless)
    got, got_aux = t_moe.moe_ffn(tp, torch.from_numpy(x), tmoe, mlp_type, dropless=dropless)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6, atol=1e-7)
    logits = torch.from_numpy(x.reshape(-1, D)) @ tp["router"]
    _, _, ids = t_moe.route(logits, 2)
    C = t_moe.capacity(27, tmoe, dropless)
    drops = int((~t_moe.dispatch(ids, 8, C)[1]).sum())
    assert drops == 0 if dropless else (drops > 0 or cf >= 1.25), drops


def test_shared_expert_and_moe_ffn_ep():
    """The shared experts add exactly their one wide MLP to the routed
    output, and ``moe_ffn_ep`` is ``moe_ffn`` without a mesh, as the
    reference falls back."""
    rng = np.random.default_rng(504)
    rmoe, tmoe = _configs(8, 2, 2, 1.25)
    jp, tp = _params(rmoe)
    x = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))
    y, aux = t_moe.moe_ffn(tp, x, tmoe, "swiglu")
    y_ep, aux_ep = t_moe.moe_ffn_ep(tp, x, tmoe, "swiglu")
    assert torch.equal(y, y_ep) and torch.equal(aux, aux_ep)
    want_ep, _ = r_moe.moe_ffn_ep(jp, jnp.asarray(x.numpy()), rmoe, "swiglu")
    np.testing.assert_allclose(_np(y_ep), _np(want_ep), rtol=1e-5, atol=1e-5)
    no_experts = {**tp, "router": tp["router"] * 0.0}
    routed_only = t_moe.moe_ffn({k: v for k, v in no_experts.items() if k != "shared"},
                                x, _configs(8, 2, 0)[1], "swiglu")[0]
    both = t_moe.moe_ffn(no_experts, x, tmoe, "swiglu")[0]
    np.testing.assert_allclose(_np(both - routed_only),
                               _np(mlp(tp["shared"], x.reshape(-1, D), "swiglu").reshape(x.shape)),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def host_mesh():
    """A one-process ``(1, 1)`` gloo mesh, its group torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    started = not dist.is_initialized()
    yield make_host_mesh("cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_ep_per_shard_path_on_a_host_mesh(host_mesh, dropless):
    """On a ``(1, 1)`` mesh ``moe_ffn_ep`` takes its per-shard path (E % 1
    == 0: expert-parallel), as the reference's does: ``moe_ffn``'s output
    within 2e-5 and its aux loss within 1e-6 (the reference's numbers), the
    output a DTensor on the mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import lm_mesh

    rng = np.random.default_rng(506)
    _, tmoe = _configs(8, 2, 1, 1.25)
    _, tp = _params(_configs(8, 2, 1, 1.25)[0])
    x = torch.from_numpy(rng.standard_normal((2, 7, D)).astype(np.float32))
    want, want_aux = t_moe.moe_ffn(tp, x, tmoe, "swiglu", dropless=dropless)
    with lm_mesh(host_mesh):
        y, aux = t_moe.moe_ffn_ep(tp, x, tmoe, "swiglu", dropless=dropless)
    assert isinstance(y, DTensor) and y.device_mesh == host_mesh
    np.testing.assert_allclose(_np(y.full_tensor()), _np(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(aux.full_tensor()), float(want_aux), rtol=0, atol=1e-6)


def test_moe_ffn_in_bf16_follows_the_reference():
    """bf16 weights and activations, as served: the router's logits are
    bf16 products, so the routing is compared where no token's k-th and
    (k+1)-th logits tie within two bf16 units (there the two packages may
    pick either expert); those tokens' outputs within two bf16 units of the
    output's scale (bf16 expert products, rounded at other points)."""
    rng = np.random.default_rng(505)
    rmoe, tmoe = _configs(8, 2, 1, 1.25)
    jp, tp = _params(rmoe)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = jax.tree_util.tree_map(lambda a: a.bfloat16(), tp)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    want, _ = r_moe.moe_ffn(jp, jx, rmoe, "swiglu", dropless=True)
    got, _ = t_moe.moe_ffn(tp, tx, tmoe, "swiglu", dropless=True)
    logits = (tx.reshape(-1, D) @ tp["router"]).float()
    top = torch.sort(logits, dim=-1, descending=True).values
    clear = (top[:, 1] - top[:, 2] > 2 * 2.0 ** -7 * top[:, 1:3].abs().amax(-1)).numpy()
    assert clear.sum() >= clear.size // 2
    w, g = _np(want).reshape(-1, D)[clear], _np(got).reshape(-1, D)[clear]
    np.testing.assert_allclose(g, w, rtol=0, atol=2 * 2.0 ** -7 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_moe_lm_prefill_and_teacher_forced_decode(name, dtype_name, monkeypatch):
    """deepseek-moe-16b reduced (a dense prefix layer, then MoE with a
    shared expert) and qwen2-moe reduced: decode is dropless, prefill at the
    reduced config's capacity."""
    teacher_forced_parity(name, dtype_name, monkeypatch)
