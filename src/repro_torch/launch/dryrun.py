"""Dry run on a fake world: does a config fit and shard on 256 or 512 cards?

Twin of the reference's ``launch/dryrun.py``, which lowers and compiles the
real step of every (architecture x input shape x mesh) cell against 256
(one pod, 16 x 16) or 512 (two pods, 2 x 16 x 16) placeholder devices and
reads XLA's memory and cost analyses.  PyTorch compiles nothing ahead of
time, so the port *runs* the step once instead, on ``meta`` tensors in a
one-process ``torch.distributed`` world of backend ``fake`` (rank 0 of 256
or 512; no collective moves a byte and nothing is allocated or computed):

* ``train_*``   the plan-based ``train_step`` (``make_train_step``);
* ``prefill_*`` ``LM.prefill`` under the plan, its emitted cache laid out by
  ``plan.cache_specs`` (the reference pins its output to them);
* ``decode_*``  ``LM.decode_step`` under the plan over a cache laid out by
  ``cache_specs``, updated in place (the reference donates it); at 32k rows
  and more the cache's sequence dim is split over 'model' and B7 runs its
  sequence-split entry on each rank's rows.

Every operand is a DTensor on ``meta`` built from rank 0's block alone (no
global tensor): parameters by ``plan.param_specs``, AdamW moments by
``plan.opt_specs``, tokens by ``plan.batch_spec``, the cache by
``plan.cache_specs``.  The step runs once under the per-rank census and
the live-bytes tracker of ``roofline.hlo_analysis``
(:func:`~repro_torch.roofline.hlo_analysis.analyze_with_memory`): what rank
0 executes and holds.  One JSON per cell under ``--out`` (default
``artifacts/dryrun_torch``) with the reference's keys:

* the ``RooflineReport`` of the census at the H100's published peaks
  (``roofline/model.py``: 989 TFLOP/s bf16, 67 TFLOP/s float32 outside
  the tensor cores, 3.35 TB/s HBM, 450 GB/s NVLink a direction), so the
  ``t_*`` columns are H100 times per card: ``flops_per_device`` is the
  bf16 products, the compute term adds the float32 products, B7's
  operations and the elementwise ops at the float32 rate (the reference's
  key set has no column of its own for them);
* ``memory_analysis``: ``argument_size_in_bytes`` the rank's blocks of the
  inputs an output depends on (``jax.jit`` drops an input no output
  needs, such as hymba's meta tokens in decode), ``output_size_in_bytes``
  its blocks of the outputs,
  ``alias_size_in_bytes`` the outputs written in place into inputs'
  storage (params and moments in training, the cache in decode),
  ``peak_bytes_per_device`` the tracker's high-water mark and
  ``temp_size_in_bytes`` = peak - argument - output + alias;
  ``generated_code_size_in_bytes`` None; ``peak_by_op`` (the port's own
  key) the live bytes at the peak by the op that made them.  The
  reference's question "does it fit 16 GB of HBM" becomes "does it fit the
  H100's 80 GB";
* ``t_lower_s`` the run's seconds, ``t_compile_s`` 0.0 (nothing compiles);
* ``xla_cost_analysis_flops`` / ``_bytes``: their closest counterpart, the
  census's products' FLOPs (every dtype, B7's operations included) and its
  bytes; ``while_trip_counts`` and ``hlo_bytes`` None (no HLO: the census
  counts every iteration of a Python loop as it runs).

One fake world per process: ``lower_cell`` starts the world its mesh needs
(256 or 512 ranks) and raises, naming the world, in a process that already
has another; ``--mesh both`` runs each mesh's cells in a subprocess of its
own.  Run with ``python -m repro_torch.launch.dryrun --arch gemma-2b --mesh
both``; no card is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

MESH_NAMES = {False: "single", True: "multi"}


def fake_world(size: int) -> None:
    """A one-process ``fake`` world of ``size`` ranks, this process rank 0;
    raises where the process already has a world of another size or
    backend."""
    import torch.distributed as dist

    if dist.is_initialized():
        have, backend = dist.get_world_size(), dist.get_backend()
        if have != size or backend != "fake":
            raise RuntimeError(f"this process already has a {backend} world of {have} ranks; "
                               f"a dry run of {size} ranks needs a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _all_to_all_as_the_card_issues():
    """DTensor falls back to an all-gather and a chunk for an all-to-all on a
    CPU mesh (gloo has none); the dry run's mesh is a CPU one, so this
    issues the all-to-all a card's mesh does, for the census to count it
    as one."""
    import contextlib

    import torch
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # the group's name, as torch 2.11 and 2.13 both resolve it
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._resolve_group_name((mesh, mesh_dim)))

    @contextlib.contextmanager
    def patched():
        orig = placement_types.shard_dim_alltoall
        placement_types.shard_dim_alltoall = shard_dim_alltoall
        try:
            yield
        finally:
            placement_types.shard_dim_alltoall = orig

    return patched()


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool, variant: str = "baseline"):
    """Run one cell's step once on ``meta`` DTensors over the fake world;
    returns ``(report_dict, None)`` (no compiled object exists)."""
    import torch

    from repro_torch.configs import SHAPES, get_arch, param_count, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.lm import LM, make_serve_steps
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel.sharding import NamedSharding, P, abstract_placed, make_plan
    from repro_torch.roofline import RooflineReport, model_flops_estimate
    from repro_torch.roofline.hlo_analysis import analyze_with_memory
    from repro_torch.train import make_train_step

    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh_name = MESH_NAMES[bool(multi_pod)]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "skipped": True, "reason": why}, None

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh.size()
    remat = "full" if shape.kind == "train" else "none"
    plan = make_plan(cfg, mesh, kind=shape.kind)
    lm = LM(cfg, remat=remat, chunk_q=512, loss_chunk=512,
            attn_seq_shard=(plan.attn_mode == "seq"))

    B, S = shape.global_batch, shape.seq_len
    # patches/meta tokens count toward the seq budget: the cache is exactly S
    n_text = S - cfg.prefix_tokens - cfg.meta_tokens

    def placed(t, spec):
        return abstract_placed(t, NamedSharding(mesh, spec))

    def meta(*size, dtype=torch.int32):
        return torch.empty(size, dtype=dtype, device="meta")

    params_abs = lm.abstract_params()
    params = abstract_placed(params_abs, plan.param_shardings(params_abs))
    pe = None
    if cfg.modality == "vision_stub":
        pe = placed(meta(B, cfg.prefix_tokens, cfg.d_model, dtype=torch.float32),
                    plan.batch_spec(3))
    t0 = time.perf_counter()
    with _all_to_all_as_the_card_issues():
        if shape.kind == "train":
            opt_abs = init_opt_state(params_abs)
            opt = abstract_placed(opt_abs, plan.opt_shardings(params_abs))
            step, _ = make_train_step(lm, plan, AdamWConfig())
            args = [params, opt, placed(meta(B, n_text), plan.batch_spec(2))]
            if pe is not None:
                args.append(pe)
            census, memory, _ = analyze_with_memory(step, *args)
        else:
            prefill, decode = make_serve_steps(lm, plan)
            with torch.no_grad():
                if shape.kind == "prefill":
                    args = [params, placed(meta(B, n_text), plan.batch_spec(2)), S]
                    if pe is not None:
                        args.append(pe)
                    census, memory, _ = analyze_with_memory(prefill, *args)
                else:
                    cache_abs = lm.abstract_cache(B, S)
                    cache = abstract_placed(cache_abs, plan.cache_shardings(cache_abs))
                    census, memory, _ = analyze_with_memory(
                        decode, params, placed(meta(B, 1), P(None, None)), cache,
                        placed(meta(B), P(None)))
    t_lower = time.perf_counter() - t0

    counts = param_count(cfg)
    bf16 = census.flops_by_dtype.get("bfloat16", 0.0) + census.flops_by_dtype.get("float16", 0.0)
    report = RooflineReport(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=bf16,
        f32_flops_per_device=census.flops - bf16 + census.elementwise_ops,
        bytes_per_device=census.hbm_bytes,
        coll_bytes_per_device=census.collective_bytes,
        model_flops=model_flops_estimate(cfg, shape, counts["active"]),
        peak_memory_per_device=memory.peak_bytes,
        coll_breakdown={k: int(v) for k, v in census.coll_breakdown.items()},
    )
    out = report.to_dict()
    del out["f32_flops_per_device"]   # the reference's key set; t_compute_s holds it
    out.update({
        "variant": variant,
        "skipped": False,
        "attn_mode": plan.attn_mode,
        "t_lower_s": t_lower,
        "t_compile_s": 0.0,
        "memory_analysis": {
            "argument_size_in_bytes": memory.argument_bytes,
            "output_size_in_bytes": memory.output_bytes,
            "temp_size_in_bytes": memory.temp_bytes,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": memory.alias_bytes,
            "peak_bytes_per_device": memory.peak_bytes,
            "peak_by_op": dict(list(memory.peak_by_op.items())[:8]),
        },
        "xla_cost_analysis_flops": census.flops,
        "xla_cost_analysis_bytes": census.hbm_bytes,
        "while_trip_counts": None,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "hlo_bytes": None,
    })
    return out, None


def cell_id(arch: str, shape: str, mesh: str, variant: str) -> str:
    return f"{arch}__{shape}__{mesh}" + ("" if variant == "baseline" else f"__{variant}")


def _both(argv) -> int:
    """``--mesh both``: each mesh's cells in a process (a world) of its own."""
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    rc = 0
    for mesh in ("single", "multi"):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--mesh", mesh]
        rc = max(rc, subprocess.run(cmd, env=env).returncode)
    return rc


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS, SHAPES

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run the full matrix")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        return _both([a for a in argv if a not in ("--mesh", "both")])

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    multi = args.mesh == "multi"

    failures = []
    for arch in archs:
        for shape in shapes:
            mname = MESH_NAMES[multi]
            cid = cell_id(arch, shape, mname, args.variant)
            path = os.path.join(args.out, cid + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip existing] {cid}")
                continue
            print(f"[dryrun] {cid} ...", flush=True)
            try:
                report, _ = lower_cell(arch, shape, multi, args.variant)
            except Exception as e:
                traceback.print_exc()
                failures.append((cid, repr(e)))
                report = {"arch": arch, "shape": shape, "mesh": mname,
                          "variant": args.variant, "error": repr(e)}
            with open(path, "w") as f:
                json.dump(report, f, indent=1)
            if report.get("skipped"):
                print(f"  -> SKIPPED: {report['reason']}")
            elif "error" in report:
                print(f"  -> ERROR: {report['error']}")
            else:
                print(
                    f"  -> ok  compile {report['t_compile_s']:.1f}s  "
                    f"bottleneck {report['bottleneck']}  "
                    f"t=({report['t_compute_s']:.2e},"
                    f"{report['t_memory_s']:.2e},"
                    f"{report['t_collective_s']:.2e})s  "
                    f"mem/dev "
                    f"{(report['memory_analysis']['peak_bytes_per_device'] or 0)/2**30:.2f}GiB",
                    flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for cid, err in failures:
            print(f"  {cid}: {err}")
        return 1
    print("\nall requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
