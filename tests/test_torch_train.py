"""Port parity, the training path: ``LM.loss`` and its autograd grads,
``train_step``, ``train_loop`` with checkpoint and resume, and the train
CLI, against the reference's ``jax.value_and_grad`` of its ``LM.loss``,
its ``train_step`` and its ``train_loop``, on reduced configs.

xlstm-1.3b and hymba-1.5b run with their pattern cut to one layer of
each kind (:data:`CUT`).  Parameters are drawn once per config by the port's ``LM.init`` from a
seeded ``torch.Generator`` on the CPU and handed to both packages as
numpy arrays; tokens and stub embeddings come from a seeded numpy
generator.  Batch 2, 24 tokens, ``loss_chunk`` 10 (23 positions: two
chunks and a ragged tail of 3), ``chunk_q`` 8 (three query chunks, so the
per-chunk remat runs).

Tolerances, each with its reason:

- float32 compute: loss relative 1e-5; every grad leaf ``max|d| <= 1e-4
  max|g|``.  The same float32 function through other kernels (XLA's and
  ATen's reductions, ``logsumexp`` and products sum in other orders); the
  largest gap read is 5e-5 of hymba's ``ssm_a_log`` grad, whose chunked
  recurrence multiplies exponentials of summed log-decays.
- bf16 compute (gemma-2b): XLA rounds every bf16 primitive and PyTorch
  rounds at other points, so each package lies off the float32 result by
  bf16 noise of its own.  Each grad leaf within twice the reference's own
  bf16-vs-float32 gap on that leaf, plus the float32 tolerance.  The loss,
  a mean over 46 positions whose noise partly cancels (the reference's
  bf16 loss lies 5.5e-5 off its float32 one, the port's 1.2e-4 off the
  reference's), within the mean over positions of the reference's own
  |bf16 - float32| gap of the per-position loss (1.3e-3).
- ``remat="full"`` against ``"none"``: the same operations recomputed,
  relative 1e-6 (grad accumulation may add the same terms in another
  order).
- Three ``train_step``s, the third compressed: loss and metrics relative
  1e-5 at every step.  After two steps, ``m`` and ``v`` (linear in the
  grads) within 1e-4 of their largest element; params within 1e-4 of
  theirs plus 5% of the learning rate: Adam's update divides two moments
  that both vanish with the grad, so where a grad element is near 0 its
  float32 noise is a large share of it and moves the update by a share of
  one step (measured: 0.02% of ``w_down``'s elements, by up to 1.5% of the
  learning rate).  After the compressed step, a
  grad element within its tolerance that lies at an int8 rounding boundary
  may round to the neighbouring level in the other package: at most 0.1%
  (and at least one) of the elements of the carried error may differ by
  up to one level,
  and of the params (by up to two learning rates: one step) and moments.
  The others' carried error within 2.5% of a level: the grads' tolerance,
  1e-4 of the largest grad element, is 1.3% of a level (the largest over
  127), and the level moves with the largest element.
- Losses after a resume across packages: relative 1e-4 (five steps of
  AdamW from the same state, each grad within its float32 tolerance).
"""

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R_optim
from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.data import TokenPipeline as RPipeline
from repro.models.layers import unembed as r_unembed
from repro.models.linear_rnn import gla_chunked as r_gla
from repro.models.lm import LM as R_LM
from repro.train import LoopConfig as RLoopConfig
from repro.train import train_loop as r_train_loop
from repro.train import train_step as r_train_step

import repro_torch.train.loop as loop_mod
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, opt_state_from_numpy
from repro_torch.models.linear_rnn import gla_chunked as t_gla
from repro_torch.optim import AdamWConfig, init_error_state
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.train import LoopConfig, init_train_state, make_train_step, train_loop, \
    train_step
from repro_torch.tree import flatten_with_path, leaves, tree_map

B, S, CHUNK_Q, LOSS_CHUNK = 2, 24, 8, 10
#: name -> (the reference's remat, zloss): one case with the reference's
#: remat and one with a z-loss; the port runs remat="full" in every case.
PARITY = {
    "gemma-2b": ("full", 1e-3),
    "gemma3-12b": ("none", 0.0),        # 5 local (window 16) + 1 global
    "deepseek-moe-16b": ("none", 0.0),  # dense prefix, MoE aux loss
    "xlstm-1.3b": ("none", 0.0),
    "hymba-1.5b": ("none", 0.0),        # meta tokens, local/global
    "paligemma-3b": ("none", 0.0),      # prefix_embeds, prefix-LM mask
    "musicgen-medium": ("none", 0.0),
}


#: xlstm's and hymba's patterns cut to one layer of each kind (the
#: reference compiles a superblock of eight layers for 12-15 s).
CUT = {"xlstm-1.3b": ("mlstm", "slstm"), "hymba-1.5b": ("hymba_g", "hymba")}


def _cfg(name, archs, reduce):
    cfg = reduce(archs[name])
    if name in CUT:
        cfg = dataclasses.replace(cfg, pattern=CUT[name], num_layers=len(CUT[name]))
    return cfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(params as numpy, tokens, stub embeddings or None) of a config."""
    cfg = _cfg(name, ARCHS, reduced)
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = None
    if cfg.modality == "vision_stub":
        pe = (0.02 * rng.standard_normal((B, cfg.prefix_tokens, cfg.d_model))).astype(np.float32)
    return tree_map(lambda t: t.numpy(), params), tokens, pe


@functools.lru_cache(maxsize=None)
def _reference(name, bf16=False):
    """The reference's (loss, aux, grads in JAX's leaf order) of a config."""
    remat, zloss = PARITY[name]
    lm = R_LM(_cfg(name, R_ARCHS, r_reduced), remat=remat, chunk_q=CHUNK_Q,
              loss_chunk=LOSS_CHUNK, zloss=zloss, compute_dtype=jnp.bfloat16 if bf16 else None)
    params, tokens, pe = _case(name)
    fn = jax.jit(jax.value_and_grad(lm.loss, has_aux=True))
    (loss, metrics), grads = fn(tree_map(jnp.asarray, params), jnp.asarray(tokens),
                                None if pe is None else jnp.asarray(pe))
    return float(loss), float(metrics["aux"]), [_np(g) for g in jax.tree_util.tree_leaves(grads)]


def _port(name, bf16=False, remat="full"):
    """The port's (loss, aux, grads in JAX's leaf order) of a config."""
    _, zloss = PARITY[name]
    lm = LM(_cfg(name, ARCHS, reduced), remat=remat, chunk_q=CHUNK_Q, loss_chunk=LOSS_CHUNK,
            zloss=zloss, compute_dtype=torch.bfloat16 if bf16 else None)
    params, tokens, pe = _case(name)
    params = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
    loss, metrics = lm.loss(params, torch.from_numpy(tokens),
                            None if pe is None else torch.from_numpy(pe))
    grads = torch.autograd.grad(loss, leaves(params))
    return float(loss.detach()), float(metrics["aux"].detach()), [_np(g) for g in grads]


@pytest.mark.parametrize("name", list(PARITY))
def test_loss_and_grads_match_the_reference(name):
    want_loss, want_aux, want = _reference(name)
    loss, aux, got = _port(name)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5, atol=1e-7)
    if R_ARCHS[name].moe is not None:
        assert want_aux > 0
    paths = [p for p, _ in flatten_with_path(_case(name)[0])]
    assert len(got) == len(want) == len(paths)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path


def _reference_token_gap(name):
    """The mean over positions of |bf16 - float32| of the reference's
    per-position loss term (CE plus z-loss) on the same inputs."""
    _, zloss = PARITY[name]
    params, tokens, _ = _case(name)

    def per_position(compute_dtype):
        lm = R_LM(_cfg(name, R_ARCHS, r_reduced), chunk_q=CHUNK_Q, compute_dtype=compute_dtype)

        def f(p, t):
            h, _, _ = lm.forward(p, t)
            logits = r_unembed(p["embed"], h[:, :-1])
            lse = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, t[:, 1:, None], axis=-1)[..., 0]
            return lse - gold + zloss * lse ** 2

        return np.asarray(jax.jit(f)(tree_map(jnp.asarray, params), jnp.asarray(tokens)))

    return float(np.abs(per_position(jnp.bfloat16) - per_position(None)).mean())


def test_bf16_loss_and_grads_within_the_reference_gap():
    name = "gemma-2b"
    _, _, f32 = _reference(name)
    want_loss, _, want = _reference(name, bf16=True)
    loss, _, got = _port(name, bf16=True)
    port_f32_loss, _, _ = _port(name)
    gap = _reference_token_gap(name)
    assert abs(loss - want_loss) <= gap + 1e-5 * abs(want_loss)
    assert loss != port_f32_loss                 # the port does compute in bf16
    for g, w, w32 in zip(got, want, f32):
        tol = 2 * np.abs(w - w32).max() + 1e-4 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol


def _chip_smoke(monkeypatch):
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", module)   # its dataclasses look it up
    spec.loader.exec_module(module)
    return module


def test_bf16_limits_cover_the_reference_gap(monkeypatch):
    """``chip_smoke.py`` phase 15 (b) holds full-width gemma-2b's bf16 loss
    and grads to its float32 ones within limits set at least 20x the
    reference's own gap here (reduced gemma-2b, 2 x 24 tokens): loss
    distance, grad global-norm ratio, 1 - cosine of the flattened grads."""
    cs = _chip_smoke(monkeypatch)
    name = "gemma-2b"
    f32_loss, _, f32 = _reference(name)
    bf16_loss, _, bf16 = _reference(name, bf16=True)
    b, f = np.concatenate([g.ravel() for g in bf16]), np.concatenate([g.ravel() for g in f32])
    loss_rel = abs(bf16_loss - f32_loss) / abs(f32_loss)
    ratio = float(np.linalg.norm(b) / np.linalg.norm(f))
    one_minus_cos = 1 - float(b @ f / np.linalg.norm(b) / np.linalg.norm(f))
    assert 0 < loss_rel and 20 * loss_rel <= cs.BF16_LOSS_REL
    assert 20 * abs(ratio - 1) <= cs.BF16_NORM_RATIO
    assert 0 < one_minus_cos and 20 * one_minus_cos <= cs.BF16_ONE_MINUS_COS


@pytest.mark.parametrize("name", ["gemma3-12b", "deepseek-moe-16b", "hymba-1.5b"])
def test_remat_full_equals_none(name):
    """The recompute routes the same tokens to the same experts and the
    same chunks; loss and every grad equal."""
    full, none = _port(name, remat="full"), _port(name, remat="none")
    np.testing.assert_allclose(full[0], none[0], rtol=1e-6)
    for g, w in zip(full[2], none[2]):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


def _held(got, want, tol, budget=0.0, cap=None):
    """Every element of ``got`` within ``tol`` of ``want``, except at most a
    ``budget`` share of them (and at least one), which lie within ``cap``."""
    d = np.abs(_np(got) - _np(want))
    off = d > tol
    assert off.sum() <= (max(1, budget * off.size) if budget else 0), \
        f"{off.mean():.2e} of the elements off by up to {d.max():.2e}"
    if off.any():
        assert d.max() <= cap


def test_gla_grads_stay_finite_past_float32_decay_range():
    """A reference fault the port does not keep: the chunked GLA masks its
    intra-chunk weights after the exp, so a masked gap past float32's exp
    range (strong decays over a chunk, as hymba has at full width) gives
    inf there and NaN grads; the port masks before the exp.  Same forward
    values; the port's grads finite and, where the reference's are finite
    (a weaker decay), equal to them within 1e-5 of their scale."""
    rng = np.random.default_rng(11)
    B, L, H, dk, dv = 1, 16, 2, 4, 4
    q, k, v = (rng.standard_normal((B, L, H, d)).astype(np.float32) for d in (dk, dk, dv))
    i_gate = rng.uniform(0.2, 1.0, (B, L, H)).astype(np.float32)

    def grads(log_f):
        def loss(q, k, v, lf):
            return (r_gla(q, k, v, lf, jnp.asarray(i_gate), chunk=16)[0] ** 2).sum()

        r_val = float(loss(q, k, v, log_f))
        r_g = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, log_f)
        tq, tk, tv, tf = (torch.tensor(a, requires_grad=True) for a in (q, k, v, log_f))
        t_out = (t_gla(tq, tk, tv, tf, torch.from_numpy(i_gate), chunk=16)[0] ** 2).sum()
        t_g = torch.autograd.grad(t_out, (tq, tk, tv, tf))
        return r_val, float(t_out.detach()), [np.asarray(g) for g in r_g], [g.numpy() for g in t_g]

    strong = np.full((B, L, H), -8.0, np.float32)     # 15 steps: gaps up to 120 > 88
    r_val, t_val, r_g, t_g = grads(strong)
    np.testing.assert_allclose(t_val, r_val, rtol=1e-5)
    assert any(np.isnan(g).any() for g in r_g)
    assert all(np.isfinite(g).all() for g in t_g)
    weak = -rng.uniform(0.0, 1.0, (B, L, H)).astype(np.float32)
    r_val, t_val, r_g, t_g = grads(weak)
    np.testing.assert_allclose(t_val, r_val, rtol=1e-5)
    for g, w in zip(t_g, r_g):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_three_train_steps_match_the_reference():
    """``train_step`` three times, the third with error-feedback int8
    compression, against the reference's on the same batch: losses and
    metrics at every step; moments, params and the carried error after."""
    name = "gemma-2b"
    params, tokens, _ = _case(name)
    lr = 3e-3
    ocfg = dict(lr=lr, warmup_steps=1, total_steps=4)
    r_lm = R_LM(r_reduced(R_ARCHS[name]), remat="none", chunk_q=CHUNK_Q,
                loss_chunk=LOSS_CHUNK, compute_dtype=None)
    t_lm = LM(reduced(ARCHS[name]), chunk_q=CHUNK_Q, loss_chunk=LOSS_CHUNK, compute_dtype=None)
    r_cfg, t_cfg = R_optim.AdamWConfig(**ocfg), AdamWConfig(**ocfg)
    rp = tree_map(jnp.asarray, params)
    ro, re = R_optim.init_opt_state(rp), R_optim.init_error_state(rp)
    tp = tree_map(torch.tensor, params)
    to = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, ro), device="cpu")
    te = init_error_state(tp)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)

    def pairs():
        """(port leaf, reference leaf, "p"/"m"/"v") of params and moments."""
        for kind, got, want in (("p", tp, rp), ("m", to["m"], ro["m"]), ("v", to["v"], ro["v"])):
            for g, w in zip(leaves(got), jax.tree_util.tree_leaves(want)):
                yield g, w, kind

    r_step = jax.jit(functools.partial(r_train_step, r_lm, r_cfg))
    for _ in range(2):
        rp, ro, rm = r_step(rp, ro, jt)
        tp2, to2, tm = train_step(t_lm, t_cfg, tp, to, tt)
        assert tp2 is tp and to2 is to                 # in place
        for k in ("loss", "ce", "grad_norm", "clip_scale", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5, err_msg=k)
    for g, w, kind in pairs():
        # see the module docstring: Adam's normalised update
        _held(g, w, 1e-4 * np.abs(_np(w)).max() + (0.05 * lr if kind == "p" else 0.0))

    rp, ro, re, rm = jax.jit(functools.partial(r_train_step, r_lm, r_cfg, grad_compress=True))(
        rp, ro, jt, None, err_state=re)
    _, _, te, tm = train_step(t_lm, t_cfg, tp, to, tt, grad_compress=True, err_state=te)
    for k in ("loss", "ce", "grad_norm", "clip_scale", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5, err_msg=k)
    assert int(to["count"]) == int(ro["count"]) == 3
    for g, w in zip(leaves(te), jax.tree_util.tree_leaves(re)):
        level = 2 * np.abs(_np(w)).max()         # |error| <= half an int8 level
        _held(g, w, 0.025 * level, budget=1e-3, cap=1.05 * level)
    for g, w, kind in pairs():
        _held(g, w, 1e-4 * np.abs(_np(w)).max(), budget=1e-3,
              cap=2 * lr if kind == "p" else 0.1 * np.abs(_np(w)).max())


def test_resume_from_a_reference_checkpoint(tmp_path):
    """``repro``'s ``train_loop`` checkpoints at step 5; the port's resumes
    from that checkpoint to step 10, and its losses equal ``repro``'s
    straight 10-step run."""
    name = "gemma-2b"
    r_lm = R_LM(r_reduced(R_ARCHS[name]), remat="none", chunk_q=16, loss_chunk=16,
                compute_dtype=None)
    t_lm = LM(reduced(ARCHS[name]), remat="none", chunk_q=16, loss_chunk=16, compute_dtype=None)
    cfg = reduced(ARCHS[name])
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    r_pipe = RPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    t_pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    d = str(tmp_path / "ck")
    straight = r_train_loop(r_lm, RLoopConfig(steps=10, log_every=0),
                            R_optim.AdamWConfig(**ocfg), r_pipe)
    r_train_loop(r_lm, RLoopConfig(steps=5, ckpt_every=5, ckpt_dir=d, log_every=0),
                 R_optim.AdamWConfig(**ocfg), r_pipe)
    resumed = train_loop(t_lm, LoopConfig(steps=10, ckpt_every=5, ckpt_dir=d, log_every=0),
                         AdamWConfig(**ocfg), t_pipe, device="cpu")
    assert resumed["step"] == list(range(5, 10))
    np.testing.assert_allclose(resumed["loss"], straight["loss"][5:], rtol=1e-4)


def test_remat_must_be_none_or_full():
    with pytest.raises(ValueError, match="remat"):
        LM(reduced(ARCHS["gemma-2b"]), remat="dots")


@pytest.mark.parametrize("name", ["gemma-2b", "xlstm-1.3b", "deepseek-moe-16b"])
@pytest.mark.parametrize("option", ["seq_parallel", "attn_seq_shard"])
def test_mesh_options_are_the_identity_off_mesh(option, name):
    """``seq_parallel`` and ``attn_seq_shard`` shard over an LM mesh; off
    it they change nothing: loss and every grad bitwise the same."""
    _, zloss = PARITY[name]
    cfg = _cfg(name, ARCHS, reduced)
    params, tokens, _ = _case(name)

    def run(**kw):
        lm = LM(cfg, chunk_q=CHUNK_Q, loss_chunk=LOSS_CHUNK, zloss=zloss, compute_dtype=None, **kw)
        diff = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
        loss, _ = lm.loss(diff, torch.from_numpy(tokens))
        return loss, torch.autograd.grad(loss, leaves(diff))

    (on, g_on), (off, g_off) = run(**{option: True}), run(**{option: False})
    assert torch.equal(on, off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_no_plan_trains_on_one_device():
    """``plan=None``: one device, plain tensors in and out, no shardings."""
    cfg, lm, pipe = _setup()
    step, shardings = make_train_step(lm, None, AdamWConfig(lr=1e-3, warmup_steps=0))
    assert shardings is None
    params, opt = init_train_state(lm, None, device="cpu")
    params, opt, m = step(params, opt, torch.from_numpy(pipe.batch_at(0)))
    assert bool(torch.isfinite(m["loss"])) and int(opt["count"]) == 1
    assert all(type(t) is torch.Tensor for t in leaves(params) + leaves(opt))


def test_a_plan_over_a_mesh_the_world_cannot_build_raises():
    """A production mesh needs its whole world of processes, and a plan
    over a shape-only mesh (no process group) cannot train."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import make_plan

    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {n} processes"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")

    class ShapeOnly:
        shape, axis_names = {"data": 16, "model": 16}, ("data", "model")

    cfg, lm, _ = _setup()
    plan = make_plan(cfg, ShapeOnly())
    with pytest.raises(ValueError, match="shape-only"):
        make_train_step(lm, plan)
    with pytest.raises(ValueError, match="shape-only"):
        init_train_state(lm, plan, device="cpu")


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    assert train_cli.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "step     0" in out and "final loss" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]


def test_cli_draws_the_stub_embeddings():
    assert train_cli.main(["--arch", "paligemma-3b", "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16"]) == 0


# -- twins of tests/test_train_loop.py ----------------------------------------------


def _setup():
    cfg = reduced(ARCHS["gemma-2b"])
    lm = LM(cfg, remat="none", chunk_q=16, loss_chunk=16)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    return cfg, lm, pipe


def test_loss_decreases_over_short_run():
    """Memorisation check: repeated batch => CE must fall materially."""
    cfg, lm, pipe = _setup()
    params, opt = init_train_state(lm, device="cpu")
    tokens = torch.from_numpy(pipe.batch_at(0))
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=0, schedule="constant")
    losses = []
    for _ in range(20):
        params, opt, m = train_step(lm, ocfg, params, opt, tokens)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1, losses


def test_checkpoint_resume_is_exact(tmp_path):
    """Run 10 steps straight vs 5 + crash + resume 5: identical losses."""
    cfg, lm, pipe = _setup()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant")
    h_full = train_loop(lm, LoopConfig(steps=10, log_every=0), opt, pipe, device="cpu")
    d = str(tmp_path / "ck")
    train_loop(lm, LoopConfig(steps=5, ckpt_every=5, ckpt_dir=d, log_every=0), opt, pipe,
               device="cpu")
    h_resumed = train_loop(lm, LoopConfig(steps=10, ckpt_every=5, ckpt_dir=d, log_every=0),
                           opt, pipe, device="cpu")
    np.testing.assert_allclose(h_resumed["loss"], h_full["loss"][5:], rtol=1e-5)


def test_straggler_hook_called(monkeypatch):
    cfg, lm, pipe = _setup()
    calls = []

    class Spiky(HeartbeatMonitor):
        def stop(self, step):
            dt = super().stop(step)
            if step == 9:
                self.record(step, dt * 100)  # inject a spike
            return dt

    monkeypatch.setattr(loop_mod, "HeartbeatMonitor", Spiky)
    train_loop(lm, LoopConfig(steps=12, log_every=0,
                              straggler_hook=lambda s, dt: calls.append(s)),
               AdamWConfig(lr=1e-3, warmup_steps=0), pipe, device="cpu")
    assert calls, "straggler hook never fired"


def test_grad_compression_step_trains():
    cfg, lm, pipe = _setup()
    params, opt = init_train_state(lm, device="cpu")
    err = init_error_state(params)
    tokens = torch.from_numpy(pipe.batch_at(0))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    p2, o2, err2, m = train_step(lm, ocfg, params, opt, tokens, grad_compress=True,
                                 err_state=err)
    assert bool(torch.isfinite(m["loss"]))
    assert max(float(leaf.abs().max()) for leaf in leaves(err2)) > 0.0


def test_determinism_same_seed():
    cfg, lm, pipe = _setup()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    h1 = train_loop(lm, LoopConfig(steps=5, log_every=0), opt, pipe, device="cpu")
    h2 = train_loop(lm, LoopConfig(steps=5, log_every=0), opt, pipe, device="cpu")
    np.testing.assert_allclose(h1["loss"], h2["loss"], rtol=1e-6)
