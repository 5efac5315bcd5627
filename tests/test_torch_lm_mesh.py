"""The LM mesh on four CPU processes: a ``(2, 2)`` ``("data", "model")``
``DeviceMesh`` over gloo, held to the port's one-device runs and to the
reference's plan on a forced 4-device host mesh.

One module-scoped run of four worker processes (``_worker``, this file
run with ``-c``; a start costs ~11 s, so once a module) does every case
and rank 0 writes each case's results under a temporary directory; a JAX
subprocess, started at the same time, writes the reference's (the only
JAX in this module).  The tests read both.

- The plan-based train step (``make_train_step(lm, make_plan(cfg, mesh))``)
  against the one-device step on the same parameters and batch, for
  reduced configs covering the ``qheads``, ``heads`` and ``seq``
  attention modes (asserted), ``seq_parallel=True`` (the default),
  ``attn_seq_shard=True``, ``remat="full"``, a recurrent mixer (xlstm's
  mLSTM and sLSTM) and deepseek's dense prefix with MoE (``moe_ffn_ep``'s
  expert-parallel path), with and without ``grad_compress``; and the mLSTM
  at a batch of 2, which leaves 'model' to its heads' products (split over
  whole heads, and over a column block of one head at ``num_heads`` 1),
  and hymba's attention and SSM branches at a batch of 2.
  Tolerances
  are ``tests/test_torch_train.py``'s: loss relative 1e-5; every grad
  leaf within 1e-4 of its largest element; every parameter after one
  AdamW step within 1e-4 of its largest element plus 5% of the learning
  rate (Adam's first update is ~lr * sign(g), so a grad element at
  float32 noise may move by a share of one step).  After a compressed
  step an element at an int8 rounding boundary may round to the
  neighbouring level: at most 0.1% (and at least one) of a leaf's
  elements may differ by up to one step (two learning rates).  The mesh
  sums partial results in another order than one device (two sequential
  all-reduces over a 2-D mesh), so nothing here is bitwise.
- The CE chunk on the mesh (``models.lm.chunk_ce``: the vocab-parallel
  cross-entropy, rank by rank) against one device: loss and grads of the
  tied table, of an untied unembedding and of a whole (unsplit) table with
  a batch the data axis cannot split, at the step's tolerances.
- B7's batch-one decode plan (``models.attention._decode_attend`` over a
  float32 cache of batch 1 whose rows 'model' splits): each 'data' rank
  takes its half of v's head dim, at ``flash_attention.parity``'s float32
  tolerance against one device.
- ``moe_ffn_ep`` against ``moe_ffn`` for the expert-parallel case (E=4)
  and the hidden-dim fallback (E=3, 3 % 2 != 0): output atol 2e-5, aux
  1e-6, the reference's numbers (``tests/test_moe.py``); and at batches of
  1 and 3, which the data axis does not split (ragged token shares, one
  with a capacity that drops choices), also the grads of x and of every
  weight, at the step's grad tolerance.
- ``TokenPipeline.device_batch_at``: each rank's block equals the slice
  of ``batch_at``.
- Checkpoints: a sharded save, then ``restore(shardings=)`` and
  ``resume_or_init(shardings=)``, bitwise with the placements kept; a
  plain restore into placed tensors; a reference checkpoint restored
  sharded, and the mesh's checkpoint restored by the reference.
- ``train_loop(plan=...)`` with a checkpoint and a resume, against the
  one-device loop.
- The reference's plan step and ``moe_ffn_ep`` on a forced 4-device
  ``(2, 2)`` host mesh: the port's mesh results within the same
  tolerances.
- Serving under a plan (``make_serve_steps``): prefill under the prefill
  plan, then 3 decode steps under the decode plan, over caches whose
  sequence dim is split over 'model' (``seq_shard_min`` 8 rows, so B7's
  sequence-split entry and the lse merge run), against ``LM.prefill`` and
  ``LM.decode_step`` on one device from the same parameters and tokens.
  The cases cover every decode attention mode (``qheads``, ``heads``,
  ``head_dim``, and ``replicate`` forced by ``make_plan(attn_mode=)``),
  gemma3's ring caches and xlstm's recurrent states, gemma3 at a batch of
  one (the cache's batch whole over 'data', v's head dim split there),
  hymba's two branches and its MLP over 'model', and deepseek at a batch
  of 3, which the 2 data ranks do not split (each attends over and routes
  its ragged share of the sequences).  Logits are held at
  ``tests/test_torch_lm.py``'s tolerance (2% of the largest |logit| plus
  2e-3) and the caches at two bf16 units of their largest element (both
  sides compute in float32 over the same bf16 cache; the mesh sums in
  another order).  The decode steps update the placed cache in place.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
BATCH, SEQ, LR = 4, 24, 1e-3
LM_KW = dict(remat="none", chunk_q=8, loss_chunk=10, compute_dtype=None)
CUT = {"xlstm-1.3b": ("mlstm", "slstm"), "hymba-1.5b": ("hymba_g", "hymba")}
#: case -> (arch, config overrides, LM options, grad_compress, attention mode)
STEP_CASES = {
    "gemma-2b": ("gemma-2b", {}, {}, False, "qheads"),
    "gemma-2b-compressed": ("gemma-2b", {}, {}, True, "qheads"),
    "gemma-2b-seq": ("gemma-2b", {"num_heads": 3}, {"attn_seq_shard": True}, False, "seq"),
    "deepseek-moe-16b": ("deepseek-moe-16b", {}, {"remat": "full"}, False, "heads"),
    "xlstm-1.3b": ("xlstm-1.3b", {}, {}, False, "heads"),
    "xlstm-1.3b-heads": ("xlstm-1.3b", {}, {}, False, "heads"),
    "xlstm-1.3b-columns": ("xlstm-1.3b", {"num_heads": 1}, {}, False, "qheads"),
    "hymba-1.5b": ("hymba-1.5b", {}, {}, False, "heads"),
}
#: step cases at another batch: 2 leaves 'model' to the mixers' heads
STEP_BATCH = {"xlstm-1.3b-heads": 2, "xlstm-1.3b-columns": 2, "hymba-1.5b": 2}
MOE_CASES = {4: "ep", 3: "f_fallback"}      # experts -> the path on a model axis of 2
#: batches the data axis does not split, each split into ragged token
#: shares: case -> (experts, batch, capacity factor); a factor of 0.5
#: drops choices, in the whole batch's token order
MOE_UNSPLIT = {"4_unsplit": (4, 1, 8.0), "3_unsplit": (3, 3, 8.0),
               "4_unsplit_drops": (4, 3, 0.5)}
MOE_D, MOE_F, MOE_X = 32, 64, (4, 16, 32)
LOSS_RTOL, GRAD_REL, LR_SHARE = 1e-5, 1e-4, 0.05
MOE_ATOL, AUX_ATOL = 2e-5, 1e-6
#: case -> (arch, config overrides, forced decode attention mode or None,
#: the decode attention mode on the (2, 2) mesh)
SERVE_CASES = {
    "gemma-2b": ("gemma-2b", {}, None, "qheads"),
    "gemma-2b-head-dim": ("gemma-2b", {"num_heads": 3}, None, "head_dim"),
    "gemma-2b-replicate": ("gemma-2b", {}, "replicate", "replicate"),
    "gemma3-12b": ("gemma3-12b", {}, None, "heads"),
    "xlstm-1.3b": ("xlstm-1.3b", {}, None, "heads"),
    "gemma3-12b-batch-one": ("gemma3-12b", {}, None, "heads"),
    "hymba-1.5b": ("hymba-1.5b", {}, None, "heads"),
    "deepseek-moe-16b-ragged": ("deepseek-moe-16b", {}, None, "heads"),
}
#: serve cases at another batch (3 does not split over the 2 data ranks:
#: the MoE arch's attention and experts run ragged shares of 2 and 1)
SERVE_BATCH_OF = {"gemma3-12b-batch-one": 1, "deepseek-moe-16b-ragged": 3}
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS, SEQ_SHARD_MIN = 2, 12, 32, 3, 8
BF16_EPS = 2.0 ** -8


def _cfg(arch, **over):
    import dataclasses

    from repro_torch.configs import ARCHS, reduced

    cfg = reduced(ARCHS[arch], **over)
    if arch in CUT:
        cfg = dataclasses.replace(cfg, pattern=CUT[arch], num_layers=len(CUT[arch]))
    return cfg


def _tokens(cfg, batch: int = BATCH):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (batch, SEQ)).astype(np.int64)


def _moe_inputs(E, capacity_factor=8.0):
    """(MoEConfig, params on the CPU, x as numpy): the same on every rank."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import init_moe

    moe = MoEConfig(num_experts=E, top_k=2, num_shared=1, capacity_factor=capacity_factor)
    params = init_moe(torch.Generator().manual_seed(E), MOE_D, MOE_F, moe, "swiglu")
    x = np.random.default_rng(E).standard_normal(MOE_X).astype(np.float32)
    return moe, params, x


def _flat(tree) -> dict:
    from repro_torch.tree import flatten_with_path

    return {"/".join(map(str, path)): leaf for path, leaf in flatten_with_path(tree)}


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


# -- the worker: one rank of the (2, 2) gloo mesh -------------------------------------


def _loss_and_grads(lm, params, tokens):
    from repro_torch.parallel.axes import redistribute_like
    from repro_torch.tree import leaves, unflatten_like

    flat = leaves(params)
    diff = [p.detach().requires_grad_() for p in flat]
    loss, _ = lm.loss(unflatten_like(params, diff), tokens)
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    return loss, unflatten_like(params, [redistribute_like(g, p) for g, p in zip(grads, flat)])


def _step_case(mesh, rank, out, name):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_error_state
    from repro_torch.parallel import lm_mesh, make_plan, place
    from repro_torch.train import init_train_state, make_train_step

    arch, over, lm_kw, compressed, _ = STEP_CASES[name]
    cfg = _cfg(arch, **over)
    lm = LM(cfg, **{**LM_KW, **lm_kw})
    plan = make_plan(cfg, mesh)
    tokens = torch.from_numpy(_tokens(cfg, STEP_BATCH.get(name, BATCH)))
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    res = {"mode": plan.attn_mode}
    params, opt = init_train_state(lm, plan, seed=0, device="cpu")
    one_p, one_o = init_train_state(lm, None, seed=0, device="cpu")
    if not compressed:
        with lm_mesh(mesh), implicit_replication():
            loss, grads = _loss_and_grads(lm, params, place(tokens, plan.token_sharding()))
        one_loss, one_grads = _loss_and_grads(lm, one_p, tokens)
        res["loss"], res["one_loss"] = _np(loss), _np(one_loss)
        res.update({f"grad/{k}": _np(v) for k, v in _flat(grads).items()})
        res.update({f"one_grad/{k}": _np(v) for k, v in _flat(one_grads).items()})
    step, in_sh = make_train_step(lm, plan, ocfg, grad_compress=compressed)
    one_step, _ = make_train_step(lm, None, ocfg, grad_compress=compressed)
    if compressed:
        params, opt, _, m = step(params, opt, tokens, None, init_error_state(one_p))
        one_p, one_o, _, one_m = one_step(one_p, one_o, tokens, None, init_error_state(one_p))
    else:
        params, opt, m = step(params, opt, tokens)
        one_p, one_o, one_m = one_step(one_p, one_o, tokens)
    res["step_loss"], res["one_step_loss"] = _np(m["loss"]), _np(one_m["loss"])
    res["placed"] = np.array([all(tuple(p.placements) == s.placements for p, s in zip(
        _flat(params).values(), _flat_shardings(in_sh[0]))) and all(
        tuple(p.placements) == s.placements for p, s in zip(_flat(opt).values(),
                                                          _flat_shardings(in_sh[1])))])
    res.update({f"param/{k}": _np(v) for k, v in _flat(params).items()})
    res.update({f"one_param/{k}": _np(v) for k, v in _flat(one_p).items()})
    if rank == 0:
        np.savez(out / f"step_{name}.npz", **res)
    return params, opt, plan, lm


def _flat_shardings(tree):
    from repro_torch.parallel.sharding import is_sharding
    from repro_torch.tree import leaves

    return leaves(tree, is_leaf=is_sharding)


def _moe_case(mesh, rank, out, E, unsplit=None):
    """``moe_ffn_ep`` on the mesh against ``moe_ffn`` on one device; for an
    unsplit batch (a ``MOE_UNSPLIT`` case) also the grads of x and of
    every weight, placed as the plan places them, of ``sum(y * dy) +
    aux``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.moe import moe_ffn, moe_ffn_ep
    from repro_torch.parallel import NamedSharding, P, lm_mesh, place

    E, batch, factor = MOE_UNSPLIT[unsplit] if unsplit else (E, None, 8.0)
    moe, params, x = _moe_inputs(E, factor)
    xt = torch.from_numpy(x[:batch])
    if not unsplit:
        want, want_aux = moe_ffn(params, xt, moe, "swiglu")
        with lm_mesh(mesh), implicit_replication():
            y, aux = moe_ffn_ep(params, place(xt, NamedSharding(mesh, P("data", None, None))),
                                moe, "swiglu")
        res = dict(y=_np(y), aux=_np(aux), want=_np(want), want_aux=_np(want_aux))
        if rank == 0:
            np.savez(out / f"moe_{E}.npz", **res)
        return
    dy = torch.from_numpy(np.random.default_rng(E + batch).standard_normal(
        xt.shape).astype(np.float32))
    flat = _flat(params)
    specs = {"router": P(None, None), "shared/w_gate": P(None, "model"),
             "shared/w_up": P(None, "model"), "shared/w_down": P("model", None)}
    ep = E % 2 == 0
    for name in ("w_gate", "w_up"):
        specs[name] = P("model", None, None) if ep else P(None, None, "model")
    specs["w_down"] = P("model", None, None) if ep else P(None, "model", None)

    def loss_grads(fn, tree, x):
        leaves = {k: v.detach().requires_grad_() for k, v in tree.items()}
        xd = x.detach().requires_grad_()
        nested = {k: leaves[k] for k in ("router", "w_gate", "w_up", "w_down")}
        nested["shared"] = {k.split("/")[1]: v for k, v in leaves.items()
                            if k.startswith("shared/")}
        y, aux = fn(nested, xd, moe, "swiglu")
        grads = torch.autograd.grad((y * dy).sum() + aux, [xd, *leaves.values()])
        return y, aux, dict(zip(["x", *leaves], grads))

    want, want_aux, want_grads = loss_grads(moe_ffn, flat, xt)
    with lm_mesh(mesh), implicit_replication():
        # a batch the data axis does not split arrives whole
        y, aux, grads = loss_grads(
            moe_ffn_ep, {k: place(v, NamedSharding(mesh, specs[k])) for k, v in flat.items()},
            place(xt, NamedSharding(mesh, P(None, None, None))))
    res = dict(y=_np(y), aux=_np(aux), want=_np(want), want_aux=_np(want_aux))
    res.update({f"grad/{k}": _np(v) for k, v in grads.items()})
    res.update({f"one_grad/{k}": _np(v) for k, v in want_grads.items()})
    if rank == 0:
        np.savez(out / f"moe_{unsplit}.npz", **res)


def _tokens_case(mesh, rank, out):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(vocab_size=256, seq_len=SEQ, global_batch=BATCH, seed=7)
    layouts = {"batch over data": (Shard(0), Replicate()), "batch over both": (Shard(0), Shard(0)),
               "batch x sequence": (Shard(0), Shard(1)), "replicated": (Replicate(), Replicate())}
    ok = {}
    for label, placements in layouts.items():
        for step in (0, 5):
            dt = pipe.device_batch_at(step, mesh, placements)
            full = pipe.batch_at(step)
            d, m = mesh.get_local_rank(0), mesh.get_local_rank(1)
            if label == "batch over data":
                want = full[d * 2:(d + 1) * 2]
            elif label == "batch over both":
                want = full[d * 2 + m:d * 2 + m + 1]
            elif label == "batch x sequence":
                want = full[d * 2:(d + 1) * 2, m * 12:(m + 1) * 12]
            else:
                want = full
            ok[f"{label} step {step}"] = bool(
                np.array_equal(dt.to_local().numpy(), want)
                and np.array_equal(dt.full_tensor().numpy(), full)
                and tuple(dt.shape) == full.shape)
    every = [None] * WORLD
    dist.all_gather_object(every, ok)
    if rank == 0:
        (out / "tokens.json").write_text(json.dumps(every))


def _checkpoint_case(mesh, rank, out, params, opt, plan, lm):
    """A sharded save of the stepped gemma state; restores; a reference
    checkpoint restored sharded."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import resume_or_init
    from repro_torch.train import init_train_state

    state = {"params": params, "opt": opt}
    shardings = {"params": plan.param_shardings(params), "opt": plan.opt_shardings(params)}
    template = dict(zip(("params", "opt"), init_train_state(lm, None, seed=1, device="cpu")))
    ck = Checkpointer(str(out / "ckpt"))
    t0 = time.perf_counter()
    ck.save(1, state)
    ck.save(2, state, blocking=False)
    ck.wait()
    checks = {"save_s": time.perf_counter() - t0}

    def same(a, b) -> bool:
        return (isinstance(a, DTensor) and tuple(a.placements) == tuple(b.placements)
                and a.to_local().dtype == b.to_local().dtype
                and torch.equal(a.to_local(), b.to_local()))

    def all_same(tree):
        return all(same(a, b) for a, b in zip(_flat(tree).values(), _flat(state).values()))

    checks["restore_shardings"] = all_same(ck.restore(1, template, shardings))
    run = resume_or_init(ck, lambda: template, shardings=shardings)
    checks["resume_or_init_shardings"] = run.resumed and run.step == 2 and all_same(run.tree)
    placed = dict(zip(("params", "opt"), init_train_state(lm, plan, seed=1, device="cpu")))
    checks["restore_in_place"] = all_same(ck.restore(1, placed)) and all_same(placed)
    # the reference's checkpoint of the initial params (seed 0), sharded
    deadline = time.monotonic() + 600
    ref = out / "ref_ckpt"
    while not (ref / "step_0" / "manifest.json").exists() and time.monotonic() < deadline:
        time.sleep(0.5)
    if (ref / "step_0" / "manifest.json").exists():
        init = dict(zip(("params", "opt"), init_train_state(lm, plan, seed=0, device="cpu")))
        got = Checkpointer(str(ref)).restore(0, {"params": template["params"]},
                                             {"params": shardings["params"]})
        checks["reference_restored_sharded"] = all(
            same(a, b) for a, b in zip(_flat(got).values(), _flat(init["params"]).values()))
    else:
        checks["reference_restored_sharded"] = "no reference checkpoint appeared"
    every = [None] * WORLD
    dist.all_gather_object(every, checks)
    saved = {k: _np(v) for k, v in _flat(state).items()}
    if rank == 0:
        (out / "checkpoint.json").write_text(json.dumps(every))
        np.savez(out / "ckpt_state.npz", **saved)


def _loop_case(mesh, rank, out):
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import make_plan
    from repro_torch.train import LoopConfig, train_loop

    cfg = _cfg("gemma-2b")
    lm = LM(cfg, **LM_KW)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=5)
    ocfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=4)
    d = str(out / "loop")
    first = train_loop(lm, LoopConfig(steps=3, ckpt_every=2, ckpt_dir=d, log_every=0), ocfg,
                       pipe, plan=make_plan(cfg, mesh), device="cpu")
    resumed = train_loop(lm, LoopConfig(steps=4, ckpt_every=2, ckpt_dir=d, log_every=0), ocfg,
                         pipe, plan=make_plan(cfg, mesh), device="cpu")
    if rank == 0:
        straight = train_loop(lm, LoopConfig(steps=4, log_every=0), ocfg, pipe, device="cpu")
        (out / "loop.json").write_text(json.dumps({
            "mesh": first["loss"] + resumed["loss"], "mesh_steps": first["step"] + resumed["step"],
            "one": straight["loss"]}))


def _serve_case(mesh, rank, out, name):
    """Plan prefill and 3 plan decode steps against one device."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models import LM
    from repro_torch.models.lm import make_serve_steps
    from repro_torch.parallel import make_plan
    from repro_torch.tree import leaves

    arch, over, mode, _ = SERVE_CASES[name]
    cfg = _cfg(arch, **over)
    pre_plan = make_plan(cfg, mesh, kind="prefill")
    dec_plan = make_plan(cfg, mesh, attn_mode=mode, kind="decode")
    lm = LM(cfg, remat="none", chunk_q=8, compute_dtype=None,
            attn_seq_shard=pre_plan.attn_mode == "seq")
    params = lm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    batch = SERVE_BATCH_OF.get(name, SERVE_BATCH)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, SERVE_PROMPT)))
    forced = rng.integers(0, cfg.vocab_size, (batch, SERVE_STEPS))
    prefill, _ = make_serve_steps(lm, pre_plan, seq_shard_min=SEQ_SHARD_MIN)
    _, decode = make_serve_steps(lm, dec_plan, seq_shard_min=SEQ_SHARD_MIN)
    res = {"mode": dec_plan.attn_mode}
    with torch.no_grad():
        logits, cache, lengths = prefill(params, prompt, SERVE_CACHE)
        one, one_cache, one_len = lm.prefill(params, prompt, SERVE_CACHE)
        res["prefill"], res["one_prefill"] = _np(logits), _np(one)
        kv = [t for path, t in _flat(cache).items() if path.rsplit("/", 1)[-1] in ("k", "v")]
        res["seq_split"] = np.array([bool(kv) and all(
            any(isinstance(p, Shard) and p.dim == t.ndim - 3 for p in t.placements)
            for t in kv)])
        in_place = True
        for t in range(SERVE_STEPS):
            tok = torch.from_numpy(forced[:, t:t + 1])
            before = leaves(cache)
            logits, cache, lengths = decode(params, tok, cache, lengths)
            if t:
                in_place &= all(a is b for a, b in zip(before, leaves(cache)))
            one, one_cache, one_len = lm.decode_step(params, tok, one_cache, one_len)
            res[f"decode{t}"], res[f"one_decode{t}"] = _np(logits), _np(one)
        res["in_place"] = np.array([in_place and all(isinstance(x, DTensor)
                                                     for x in leaves(cache))])
        res["lengths"], res["one_lengths"] = _np(lengths), _np(one_len)
        res.update({f"cache/{k}": _np(v) for k, v in _flat(cache).items()})
        res.update({f"one_cache/{k}": _np(v) for k, v in _flat(one_cache).items()})
    if rank == 0:
        np.savez(out / f"serve_{name}.npz", **res)


def _ce_case(mesh, rank, out):
    """The CE chunk on the mesh against one device: the tied table split
    over 'model', an untied unembedding split there, and a whole table
    with a batch of 3 (whole over 'data')."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.lm import chunk_ce
    from repro_torch.parallel import NamedSharding, P, lm_mesh, place

    g = torch.Generator().manual_seed(26)
    V, D, C = 64, 32, 6
    table, unembed = torch.randn(V, D, generator=g), torch.randn(D, V, generator=g) * 0.2
    cases = {"tied": (4, {"table": P("model", None)}),
             "untied": (4, {"table": P("model", None), "unembed": P(None, "model")}),
             "whole": (3, {"table": P(None, None)})}
    res = {}
    for name, (B, specs) in cases.items():
        params = {"table": table, "unembed": unembed}
        params = {k: params[k] for k in sorted(specs)}
        h = torch.randn(B, C, D, generator=g)
        labels = torch.randint(0, V, (B, C), generator=g)

        def loss_grads(params, h, labels):
            diff = [params[k].detach().requires_grad_() for k in params]
            hd = h.detach().requires_grad_()
            loss = chunk_ce(dict(zip(params, diff)), hd, labels, 1e-3)
            grads = torch.autograd.grad(loss, diff + [hd], allow_unused=True,
                                        materialize_grads=True)
            return loss, dict(zip([*params, "h"], grads))

        one_loss, one_grads = loss_grads(params, h, labels)
        rows = P("data", None) if B % 2 == 0 else P(None, None)
        with lm_mesh(mesh), implicit_replication():
            placed = {k: place(v, NamedSharding(mesh, specs[k])) for k, v in params.items()}
            loss, grads = loss_grads(placed, place(h, NamedSharding(mesh, P(*rows, None))),
                                     place(labels, NamedSharding(mesh, rows)))
        res[f"{name}/loss"], res[f"{name}/one_loss"] = _np(loss), _np(one_loss)
        for k in grads:
            res[f"{name}/grad/{k}"], res[f"{name}/one_grad/{k}"] = _np(grads[k]), _np(one_grads[k])
    if rank == 0:
        np.savez(out / "ce.npz", **res)


#: (lengths) of the batch-one column case: rows in the first 'model'
#: block only, in both, all of them.
COLUMN_LENGTHS = (5, 20, 32)


def _column_case(mesh, rank, out):
    """B7's batch-one plan: ``_decode_attend`` over a float32 cache ``[1,
    32, 2, 16]`` whose rows 'model' splits and whose batch 'data' leaves
    whole, against one device; the head dims B7's split entry was handed
    are recorded (8: v's 16 over the 2 'data' ranks)."""
    from repro_torch.models import attention
    from repro_torch.parallel import NamedSharding, P, place

    seen = []
    entry = attention.decode_attention_split

    def spy(q, k, v, *args, **kw):
        seen.append(v.shape[-1])
        return entry(q, k, v, *args, **kw)

    g = torch.Generator().manual_seed(25)
    B, S, G, Hg, hd = 1, 32, 2, 2, 16
    k, v = (torch.randn(B, S, G, hd, generator=g) for _ in range(2))
    q = torch.randn(B, 1, G, Hg, hd, generator=g)
    k_new, v_new = (torch.randn(B, 1, G, hd, generator=g) for _ in range(2))

    def whole(t):
        return place(t, NamedSharding(mesh, P(*([None] * t.ndim))))

    res = {}
    attention.decode_attention_split = spy
    try:
        for n in COLUMN_LENGTHS:
            slots, n_rows = torch.tensor([n - 1]), torch.tensor([n])
            want = attention._decode_attend(q, k_new, v_new, k.clone(), v.clone(), slots, n_rows)
            rows = NamedSharding(mesh, P(None, "model", None, None))
            got = attention._decode_attend(whole(q), whole(k_new), whole(v_new),
                                           place(k.clone(), rows), place(v.clone(), rows),
                                           slots, n_rows)
            res[f"got{n}"], res[f"want{n}"] = _np(got), _np(want)
    finally:
        attention.decode_attention_split = entry
    res["dv"] = np.array(seen)
    if rank == 0:
        np.savez(out / "columns.npz", **res)


def _worker(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    out = Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        times = {}
        for name in STEP_CASES:
            t0 = time.perf_counter()
            state = _step_case(mesh, rank, out, name)
            if name == "gemma-2b":
                gemma = state
            times[name] = time.perf_counter() - t0
        for E in MOE_CASES:
            _moe_case(mesh, rank, out, E)
        for name in MOE_UNSPLIT:
            _moe_case(mesh, rank, out, None, unsplit=name)
        for name in SERVE_CASES:
            t0 = time.perf_counter()
            _serve_case(mesh, rank, out, name)
            times[f"serve {name}"] = time.perf_counter() - t0
        _ce_case(mesh, rank, out)
        _column_case(mesh, rank, out)
        _tokens_case(mesh, rank, out)
        _checkpoint_case(mesh, rank, out, *gemma)
        t0 = time.perf_counter()
        _loop_case(mesh, rank, out)
        times["loop"] = time.perf_counter() - t0
        if rank == 0:
            (out / "times.json").write_text(json.dumps(times))
    finally:
        dist.destroy_process_group()


# -- the reference on a forced 4-device host mesh --------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "src")
    from pathlib import Path
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.checkpoint import Checkpointer
    from repro.configs import ARCHS, MoEConfig, reduced
    from repro.models import LM
    from repro.models.moe import moe_ffn_ep
    from repro.optim import AdamWConfig, init_opt_state
    from repro.parallel.sharding import make_plan
    from repro.train.step import make_train_step

    out = Path(sys.argv[1])
    init = np.load(out / "init.npz")

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    def fill(prefix, like):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(init[prefix + key(path)]), like)

    cfg = reduced(ARCHS["gemma-2b"])
    lm = LM(cfg, remat="none", chunk_q=8, loss_chunk=10, compute_dtype=None)
    params = fill("gemma/", lm.abstract_params())
    Checkpointer(str(out / "ref_ckpt")).save(0, {"params": params})
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    plan = make_plan(cfg, mesh)
    step, _ = make_train_step(lm, plan, AdamWConfig(lr=float(sys.argv[2]), warmup_steps=0))
    with mesh:
        p2, _, m = step(params, init_opt_state(params), jnp.asarray(init["tokens"]))
    flat, _ = jax.tree_util.tree_flatten_with_path(p2)
    np.savez(out / "jax_step.npz", loss=np.asarray(m["loss"]), mode=plan.attn_mode,
             **{"param/" + key(p): np.asarray(v) for p, v in flat})
    for E in (4, 3):
        moe = MoEConfig(num_experts=E, top_k=2, num_shared=1, capacity_factor=8.0)
        mp = {k: jnp.asarray(init[f"moe{E}/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
        mp["shared"] = {k: jnp.asarray(init[f"moe{E}/shared/{k}"])
                        for k in ("w_gate", "w_up", "w_down")}
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_ffn_ep(p, x, moe, "swiglu"))(
                mp, jnp.asarray(init[f"moe{E}/x"]))
        np.savez(out / f"jax_moe_{E}.npz", y=np.asarray(y), aux=np.asarray(aux))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Runs the four workers and the reference at once; returns the
    directory of their results."""
    from repro_torch.models import LM

    out = tmp_path_factory.mktemp("lm_mesh")
    cfg = _cfg("gemma-2b")
    init = {f"gemma/{k}": v.numpy() for k, v in
            _flat(LM(cfg, **LM_KW).init(torch.Generator().manual_seed(0))).items()}
    init["tokens"] = _tokens(cfg)
    for E in MOE_CASES:
        _, params, x = _moe_inputs(E)
        init.update({f"moe{E}/{k}": v.numpy() for k, v in _flat(params).items()})
        init[f"moe{E}/x"] = x
    np.savez(out / "init.npz", **init)

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "OMP_NUM_THREADS": "1"}
    logs = {}

    def start(name, args):
        logs[name] = open(out / f"{name}.log", "w")
        return subprocess.Popen([sys.executable, "-c", *args], cwd=ROOT, env=env,
                                stdout=logs[name], stderr=subprocess.STDOUT)

    reference = start("reference", [_REFERENCE, str(out), str(LR)])
    port = _free_port()
    workers = [start(f"rank{r}", [f"import test_torch_lm_mesh as m; m._worker({r}, {port}, "
                                  f"{str(out)!r})"]) for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=480) for p in workers + [reference]]
    finally:
        for p in workers + [reference]:
            if p.poll() is None:
                p.kill()
        for f in logs.values():
            f.close()
    for name, rc in zip([*(f"rank{r}" for r in range(WORLD)), "reference"], rcs):
        assert rc == 0, f"{name} exited {rc}:\n" + (out / f"{name}.log").read_text()[-4000:]
    return out


def _held(got, want, tol, budget=0.0, cap=None, label=""):
    """Every element of ``got`` within ``tol`` of ``want``, except at most a
    ``budget`` share of them (and at least one), which lie within ``cap``."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = d > tol
    assert off.sum() <= (max(1, budget * off.size) if budget else 0), \
        f"{label}: {off.mean():.2e} of the elements off by up to {d.max():.2e} (tol {tol:.2e})"
    if off.any():
        assert d.max() <= cap, f"{label}: off by up to {d.max():.2e} (cap {cap:.2e})"


def _keys(data, prefix):
    return sorted(k[len(prefix):] for k in data.files if k.startswith(prefix))


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_plan_step_matches_one_device(mesh_run, name):
    data = np.load(mesh_run / f"step_{name}.npz")
    _, _, _, compressed, mode = STEP_CASES[name]
    assert str(data["mode"]) == mode
    assert bool(data["placed"][0]), "the step's outputs left the plan's placements"
    np.testing.assert_allclose(data["step_loss"], data["one_step_loss"], rtol=LOSS_RTOL)
    if not compressed:
        np.testing.assert_allclose(data["loss"], data["one_loss"], rtol=LOSS_RTOL)
        grads = _keys(data, "grad/")
        assert grads == _keys(data, "one_grad/") and grads
        for k in grads:
            want = data[f"one_grad/{k}"]
            _held(data[f"grad/{k}"], want, GRAD_REL * np.abs(want).max(), label=f"grad {k}")
    for k in _keys(data, "one_param/"):
        want = data[f"one_param/{k}"]
        tol = GRAD_REL * np.abs(want).max() + LR_SHARE * LR
        _held(data[f"param/{k}"], want, tol, budget=1e-3 if compressed else 0.0,
              cap=2 * LR + tol, label=f"param {k}")


def test_the_cases_cover_every_attention_mode():
    assert {case[4] for case in STEP_CASES.values()} >= {"heads", "qheads", "seq"}


@pytest.mark.parametrize("E", [*sorted(MOE_CASES), *MOE_UNSPLIT])
def test_moe_ffn_ep_matches_moe_ffn(mesh_run, E):
    """Also batches of 1 and 3, which the data axis cannot split: each data
    rank routes its ragged share of the tokens (a capacity that drops
    choices counts the whole batch), and the grads of x and of every
    weight add up to ``moe_ffn``'s."""
    data = np.load(mesh_run / f"moe_{E}.npz")
    np.testing.assert_allclose(data["y"], data["want"], atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(data["aux"], data["want_aux"], atol=AUX_ATOL, rtol=0)
    grads = _keys(data, "one_grad/")
    assert grads == _keys(data, "grad/")
    if E in MOE_UNSPLIT:
        assert {"x", "w_gate", "w_up", "w_down", "router"} <= set(grads)
    for k in grads:
        want = data[f"one_grad/{k}"]
        _held(data[f"grad/{k}"], want, GRAD_REL * np.abs(want).max(), label=f"grad {k}")


def test_device_batch_at_shards_are_batch_at_slices(mesh_run):
    every = json.loads((mesh_run / "tokens.json").read_text())
    assert len(every) == WORLD
    for rank, ok in enumerate(every):
        assert ok and all(ok.values()), (rank, ok)


def test_sharded_save_and_restore_are_bitwise(mesh_run):
    every = json.loads((mesh_run / "checkpoint.json").read_text())
    for rank, checks in enumerate(every):
        for name in ("restore_shardings", "resume_or_init_shardings", "restore_in_place",
                     "reference_restored_sharded"):
            assert checks[name] is True, (rank, name, checks[name])


def test_the_reference_restores_the_mesh_checkpoint(mesh_run):
    import jax.numpy as jnp

    from repro.checkpoint import Checkpointer as RCheckpointer

    saved = np.load(mesh_run / "ckpt_state.npz")
    like = {"params": {}, "opt": {}}
    for key in saved.files:
        node = like
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.zeros(saved[key].shape, saved[key].dtype)
    got = RCheckpointer(str(mesh_run / "ckpt")).restore(1, like)
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    assert len(flat) == len(saved.files)
    for path, leaf in flat:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), saved[key])


def test_train_loop_on_the_mesh_resumes_and_matches_one_device(mesh_run):
    run = json.loads((mesh_run / "loop.json").read_text())
    assert run["mesh_steps"] == [0, 1, 2, 3]
    np.testing.assert_allclose(run["mesh"], run["one"], rtol=LOSS_RTOL)


def test_plan_step_matches_the_reference_mesh(mesh_run):
    want = np.load(mesh_run / "jax_step.npz")
    got = np.load(mesh_run / "step_gemma-2b.npz")
    assert str(want["mode"]) == str(got["mode"])
    np.testing.assert_allclose(got["step_loss"], want["loss"], rtol=LOSS_RTOL)
    keys = _keys(want, "param/")
    assert keys == _keys(got, "param/")
    for k in keys:
        w = want[f"param/{k}"]
        _held(got[f"param/{k}"], w, GRAD_REL * np.abs(w).max() + LR_SHARE * LR,
              label=f"param {k}")


@pytest.mark.parametrize("E", sorted(MOE_CASES))
def test_moe_ffn_ep_matches_the_reference_mesh(mesh_run, E):
    want, got = np.load(mesh_run / f"jax_moe_{E}.npz"), np.load(mesh_run / f"moe_{E}.npz")
    np.testing.assert_allclose(got["y"], want["y"], atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(got["aux"], want["aux"], atol=AUX_ATOL, rtol=0)


@pytest.fixture
def host_mesh():
    """``make_host_mesh("cpu")``: a one-process gloo group, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    started = not dist.is_initialized()
    yield make_host_mesh("cpu")
    if started:
        dist.destroy_process_group()


def test_host_mesh_plan_step_equals_no_plan(host_mesh):
    """The card's phase on the CPU: a ``(1, 1)`` host mesh, the plan-based
    step of reduced gemma-2b over two fresh ``device_batch_at`` batches
    against the no-plan step from the same state, at this file's
    tolerances."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import mesh_desc
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import make_plan
    from repro_torch.train import init_train_state, make_train_step

    assert mesh_desc(host_mesh) == "1datax1model"
    cfg = _cfg("gemma-2b")
    lm = LM(cfg, **LM_KW)
    plan = make_plan(cfg, host_mesh)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=2)
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    step, _ = make_train_step(lm, plan, ocfg)
    one_step, _ = make_train_step(lm, None, ocfg)
    p, o = init_train_state(lm, plan, device="cpu")
    q, r = init_train_state(lm, None, device="cpu")
    for i in range(2):
        tokens = pipe.device_batch_at(i, host_mesh, plan.token_sharding().placements)
        assert isinstance(tokens, DTensor)
        p, o, m = step(p, o, tokens)
        q, r, n = one_step(q, r, torch.from_numpy(pipe.batch_at(i)))
        np.testing.assert_allclose(float(m["loss"]), float(n["loss"]), rtol=LOSS_RTOL)
    for k, want in _flat(q).items():
        want = want.numpy()
        _held(_np(_flat(p)[k]), want, GRAD_REL * np.abs(want).max() + LR_SHARE * LR,
              label=f"param {k}")


@pytest.mark.parametrize("vocab", ["split", "whole"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_one_card_mesh_ce_is_the_plain_ce_bit_for_bit(host_mesh, vocab, tied):
    """On a ``(1, 1)`` host mesh the vocab-parallel CE's combine over the
    vocab split is exact, whether the plan splits the vocabulary over the
    one-rank 'model' dim or leaves it whole: the loss and the grads of the
    hidden states and the table equal :func:`chunk_ce`'s plain ones, bit for
    bit (the card's one-card plan phase holds its losses to that)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.lm import chunk_ce

    rng = np.random.default_rng(7)
    B, c, D, V = 2, 5, 8, 24
    h0 = torch.from_numpy(rng.standard_normal((B, c, D)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (B, c)))
    key = "table" if tied else "unembed"
    vdim = 0 if tied else 1

    h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = chunk_ce({key: w}, h, labels, 1e-4)
    want.backward()

    model = Shard(vdim) if vocab == "split" else Replicate()
    hd = distribute_tensor(h0, host_mesh, [Replicate(), Replicate()]).requires_grad_()
    wd = distribute_tensor(w0, host_mesh, [Replicate(), model]).requires_grad_()
    got = chunk_ce({key: wd}, hd, labels, 1e-4)
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got.backward()
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(hd.grad.full_tensor(), h.grad)
    assert torch.equal(wd.grad.full_tensor(), w.grad)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b"])
def test_one_card_plan_serving_is_the_no_plan_serving_bit_for_bit(host_mesh, arch):
    """On a ``(1, 1)`` host mesh the plan's prefill and decode steps of
    reduced hymba (its decode MLP rank by rank) and deepseek (the
    expert-parallel MoE) give the no-plan path's logits bit for bit, as
    the card's one-card plan serving phase holds them."""
    from repro_torch.models import LM
    from repro_torch.models.lm import make_serve_steps
    from repro_torch.parallel import make_plan

    cfg = _cfg(arch)
    lm = LM(cfg, chunk_q=8)
    params = lm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(27)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_STEPS)))
    prefill, _ = make_serve_steps(lm, make_plan(cfg, host_mesh, kind="prefill"))
    _, decode = make_serve_steps(lm, make_plan(cfg, host_mesh, kind="decode"))
    paths = {"plan": (prefill, decode), "no_plan": (lambda p, t, n: lm.prefill(p, t, n),
                                                     lm.decode_step)}
    logits = {}
    with torch.no_grad():
        for label, (pre, dec) in paths.items():
            out, cache, lengths = pre(params, prompt, SERVE_CACHE)
            logits[label] = [out]
            for t in range(SERVE_STEPS):
                out, cache, lengths = dec(params, forced[:, t:t + 1], cache, lengths)
                logits[label].append(out)
    for i, (a, b) in enumerate(zip(logits["plan"], logits["no_plan"])):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        assert torch.equal(a, b), f"{arch} step {i}: {(a - b).abs().max():.3g} off"


def _logit_tol(want):
    return 0.02 * float(np.abs(want).max()) + 2e-3


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_plan_prefill_and_decode_match_one_device(mesh_run, name):
    data = np.load(mesh_run / f"serve_{name}.npz")
    assert str(data["mode"]) == SERVE_CASES[name][3]
    assert bool(data["in_place"][0]), "decode left the placed cache or made a new one"
    if name != "xlstm-1.3b":
        assert bool(data["seq_split"][0]), "the caches' sequence dims are not split"
    for step in ["prefill"] + [f"decode{t}" for t in range(SERVE_STEPS)]:
        want = data[f"one_{step}"]
        np.testing.assert_allclose(data[step], want, rtol=0, atol=_logit_tol(want),
                                   err_msg=f"{name} {step}")
    np.testing.assert_array_equal(data["lengths"], data["one_lengths"])
    keys = _keys(data, "one_cache/")
    assert keys == _keys(data, "cache/") and keys
    for k in keys:
        want = data[f"one_cache/{k}"]
        np.testing.assert_allclose(data[f"cache/{k}"], want, rtol=0,
                                   atol=2 * BF16_EPS * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"{name} cache {k}")


def test_the_mesh_ce_matches_one_device(mesh_run):
    data = np.load(mesh_run / "ce.npz")
    for name in ("tied", "untied", "whole"):
        np.testing.assert_allclose(data[f"{name}/loss"], data[f"{name}/one_loss"],
                                   rtol=LOSS_RTOL, err_msg=name)
        grads = _keys(data, f"{name}/one_grad/")
        assert grads == _keys(data, f"{name}/grad/") and "h" in grads
        for k in grads:
            want = data[f"{name}/one_grad/{k}"]
            _held(data[f"{name}/grad/{k}"], want, GRAD_REL * max(np.abs(want).max(), 1e-30),
                  label=f"{name} grad {k}")


def test_batch_one_decode_splits_v_columns_over_data(mesh_run):
    from repro_torch.kernels.flash_attention import parity

    data = np.load(mesh_run / "columns.npz")
    assert data["dv"].size and set(data["dv"].tolist()) == {8}, data["dv"]
    for n in COLUMN_LENGTHS:
        parity.check(torch.from_numpy(data[f"got{n}"]), torch.from_numpy(data[f"want{n}"]), [n],
                     f"batch-one decode over {n} rows")


def test_serve_cases_cover_every_decode_mode():
    assert {case[3] for case in SERVE_CASES.values()} == {"heads", "qheads", "head_dim",
                                                           "replicate"}


_CONSTRAIN = """
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate
from repro_torch.parallel.axes import constrain, from_block, lm_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
x = from_block(torch.zeros(6, 8, device="meta"), mesh, (Replicate(), Replicate()), (6, 8))
with lm_mesh(mesh):
    got = {"batch_model": constrain(x, "batch", "model").placements,
           "model_batch": constrain(x.t(), "model", "batch").placements,
           "none": constrain(x, None, None).placements}
plain = torch.zeros(6, 8)
with lm_mesh(mesh):
    same = constrain(plain, "batch", "model") is plain
print(json.dumps({"same": same, "off_mesh": constrain(x, "batch", "model") is x,
                  **{k: [str(p) for p in v] for k, v in got.items()}}))
"""


def test_constrain_leaves_a_dim_its_axes_do_not_divide_whole():
    """``constrain`` on a fake (4, 4) world: a dim of 6 over the 4 'data'
    ranks stays whole (no uneven split is asked for) while a dim of 8 over
    the 4 'model' ranks splits; off-mesh and on a plain tensor it is the
    identity."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _CONSTRAIN], cwd=root, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["same"] and got["off_mesh"]
    assert got["batch_model"] == ["R", "S(1)"]
    assert got["model_batch"] == ["R", "S(0)"]
    assert got["none"] == ["R", "R"]
