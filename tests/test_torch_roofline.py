"""Port parity, the roofline: ``repro_torch.roofline`` against the
reference's ``repro.roofline``.

The reference censuses XLA's optimized HLO of a ``lax.scan``; the port
censuses the ATen ops a Python loop executes (``hlo_analysis.analyze``).
Both must give exactly the FLOPs of the products they run: 2 * |out| *
|contracted| per product, once per loop trip.  The report's terms are
exact with the H100's published peaks.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.roofline import model_flops_estimate as ref_model_flops_estimate
from repro.roofline.hlo_analysis import analyze as ref_analyze
from repro_torch.roofline import (
    F32_FLOPS, HBM_BW, NVLINK_BW_PER_DIRECTION, PEAK_FLOPS, RooflineReport, collective_bytes,
    format_roofline_rows, model_flops_estimate, shape_bytes,
)
from repro_torch.roofline.hlo_analysis import analyze, distinct_bytes, meta_like

DEVICES = ("cpu", "meta")


def _ref_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_analyze(jax.jit(f).lower(*args).compile().as_text()).flops


def test_shape_bytes():
    assert shape_bytes((torch.float32, (16, 128))) == 16 * 128 * 4
    assert shape_bytes((torch.bfloat16, (8,))) == 16
    assert shape_bytes((torch.bool, (4, 4))) == 16
    assert shape_bytes([(torch.float32, (2, 2)), (torch.int8, (4,))]) == 16 + 4
    assert shape_bytes((torch.float32, ())) == 4


def test_collective_records():
    records = [
        ("_c10d_functional::all_reduce", ((torch.float32, (16, 1408)),)),
        ("_c10d_functional::all_gather_into_tensor", ((torch.bfloat16, (32, 64)),)),
        ("aten::add", ((torch.float32, (4,)),)),
    ]
    c = collective_bytes(records)
    assert c["all-reduce"] == 16 * 1408 * 4
    assert c["all-gather"] == 32 * 64 * 2
    assert c["total"] == c["all-reduce"] + c["all-gather"]


@pytest.mark.parametrize("device", DEVICES)
def test_census_loop_counts_every_trip(device):
    def ref(x, w):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=5)
        return y.sum()

    def port(x, w):
        c = x
        for _ in range(5):
            c = c @ w
        return c.sum()

    x = torch.zeros((64, 64), device=device)
    c = analyze(port, x, x.clone())
    assert c.flops == 5 * 2 * 64 ** 3
    assert c.flops == pytest.approx(_ref_flops(ref, (64, 64), (64, 64)))
    assert c.op_counts["mm"] == 5
    assert c.hbm_bytes > 0 and c.collective_bytes == 0


@pytest.mark.parametrize("device", DEVICES)
def test_census_nested_loops_multiply(device):
    def ref(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            ci, _ = jax.lax.scan(inner, c, None, length=3)
            return ci, None
        y, _ = jax.lax.scan(outer, x, None, length=4)
        return y.sum()

    def port(x, w):
        c = x
        for _ in range(4):
            for _ in range(3):
                c = c @ w
        return c.sum()

    x = torch.zeros((32, 32), device=device)
    c = analyze(port, x, x.clone())
    assert c.flops == 4 * 3 * 2 * 32 ** 3
    assert c.flops == pytest.approx(_ref_flops(ref, (32, 32), (32, 32)))


@pytest.mark.parametrize("device", DEVICES)
def test_census_no_loops(device):
    c = analyze(lambda a, b: (a @ b).sum(), torch.zeros((16, 64), device=device),
                torch.zeros((64, 8), device=device))
    assert c.flops == 2 * 16 * 64 * 8
    assert c.flops == pytest.approx(_ref_flops(lambda a, b: (a @ b).sum(), (16, 64), (64, 8)))
    assert c.collective_bytes == 0
    # mm reads 16x64 and 64x8 and writes 16x8; sum reads 16x8 and writes one
    assert c.hbm_bytes == 4 * (16 * 64 + 64 * 8 + 16 * 8 + 16 * 8 + 1)


def test_census_products_elementwise_and_backward():
    """bmm/addmm/baddbmm FLOPs by dtype, one op per elementwise output
    element, and the backward products of ``loss.backward()``."""
    a = torch.zeros((3, 4, 5))
    b = torch.zeros((3, 5, 6))
    c = analyze(lambda: torch.baddbmm(torch.zeros(3, 4, 6), a, b).relu())
    assert c.flops == 2 * 3 * 4 * 5 * 6
    assert c.elementwise_ops == 3 * 4 * 6
    c = analyze(lambda: torch.addmm(torch.zeros(4, 6, dtype=torch.bfloat16),
                                    torch.zeros(4, 5, dtype=torch.bfloat16),
                                    torch.zeros(5, 6, dtype=torch.bfloat16)))
    assert c.flops_by_dtype == {"bfloat16": 2 * 4 * 5 * 6}
    w = torch.zeros((5, 6), requires_grad=True)

    def step():
        (torch.zeros(4, 5, requires_grad=True) @ w).sum().backward()

    c = analyze(step)
    assert c.flops == 3 * 2 * 4 * 5 * 6   # forward, and both grads


def test_census_meta_equals_cpu():
    """A small LM's training step and decode step census the same on
    ``meta`` tensors (nothing allocated) as on the CPU."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    cfg = reduced(get_arch("gemma-2b"))
    lm = LM(cfg, remat="full", loss_chunk=16)
    params = lm.init(torch.Generator().manual_seed(0))
    step_fn, _ = make_train_step(lm, None, AdamWConfig(lr=1e-3, warmup_steps=0,
                                                       schedule="constant"))
    tokens = torch.zeros((2, 32), dtype=torch.int64)
    got = {}
    for device in DEVICES:
        p = params if device == "cpu" else meta_like(params)
        opt = init_opt_state(p) if device == "cpu" else meta_like(init_opt_state(params))
        got[device] = analyze(step_fn, p, opt, tokens.to(device)).to_dict()
    assert got["meta"] == got["cpu"]
    assert got["cpu"]["flops"] > 0 and got["cpu"]["hbm_bytes"] > 0


def test_distinct_bytes_counts_broadcasts_once():
    x = torch.zeros((1, 8), dtype=torch.float32).expand(1000, 8)
    assert distinct_bytes(x) == 32


def test_roofline_report_terms():
    r = RooflineReport(
        arch="a", shape="train_4k", mesh="single", chips=4,
        flops_per_device=989e12,            # exactly 1 second of bf16 tensor cores
        bytes_per_device=3.35e12,           # exactly 1 second of HBM
        coll_bytes_per_device=225e9,        # 0.5 s of NVLink, one direction
        model_flops=989e12 * 4,
    )
    assert (PEAK_FLOPS, F32_FLOPS, HBM_BW, NVLINK_BW_PER_DIRECTION) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck in ("compute", "memory")
    assert r.useful_flops_ratio == pytest.approx(1.0)
    assert r.mfu == pytest.approx(1.0)
    r.f32_flops_per_device = 67e12           # one more second, outside the tensor cores
    assert r.t_compute == pytest.approx(2.0)
    assert r.bottleneck == "compute" and r.step_time == pytest.approx(2.0)
    assert "train_4k" in format_roofline_rows([r])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_model_flops_estimate_matches_reference(shape):
    from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
    from repro_torch.configs import ARCHS, SHAPES

    n = 2.5e9
    got = model_flops_estimate(ARCHS["gemma-2b"], SHAPES[shape], n)
    assert got == ref_model_flops_estimate(REF_ARCHS["gemma-2b"], REF_SHAPES[shape], n)
    want = 6 * n * 256 * 4096 if shape == "train_4k" else 2 * n * 128
    assert got == pytest.approx(want)


_DTENSOR_CENSUS = """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from repro_torch.parallel.axes import from_block
from repro_torch.roofline.hlo_analysis import analyze, analyze_with_memory

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
x = from_block(torch.zeros(16, 32, device="meta"), mesh, (Shard(0), Replicate()), (64, 32))
w = from_block(torch.zeros(32, 12, device="meta"), mesh, (Replicate(), Shard(1)), (32, 48))
matmul = analyze(lambda a, b: a @ b, x, w)
gathered = analyze(lambda a: a.redistribute(mesh, (Replicate(), Replicate())), x)
census, memory, out = analyze_with_memory(lambda a, b: (a @ b).float() * 2.0, x, w)
print(json.dumps({"flops": matmul.flops, "ops": matmul.op_counts, "bytes": matmul.hbm_bytes,
                  "gathered": gathered.coll_breakdown, "out_shape": list(out.shape),
                  "memory": [memory.argument_bytes, memory.output_bytes, memory.alias_bytes,
                             memory.peak_bytes]}))
"""


def test_census_counts_what_one_rank_executes_on_dtensors():
    """A DTensor matmul on a fake (4, 4) world: the census counts the rank's
    local product (16 x 32 by 32 x 12), not the global one (64 x 32 by 32 x
    48, 16 times more), the all-gather a redistribution issues, and the
    rank's bytes (in a process of its own: one world a process)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _DTENSOR_CENSUS], cwd=root, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["flops"] == 2 * 16 * 32 * 12
    assert got["ops"] == {"mm": 1}
    assert got["bytes"] == 4 * (16 * 32 + 32 * 12 + 16 * 12)
    assert got["gathered"]["all-gather"] == 64 * 32 * 4
    assert got["out_shape"] == [64, 48]
    # arguments: the two blocks; the output: the rank's 16 x 12 block; the
    # peak holds the arguments, the product and the output at once
    assert got["memory"][:3] == [4 * (16 * 32 + 32 * 12), 4 * 16 * 12, 0]
    assert got["memory"][3] == 4 * (16 * 32 + 32 * 12) + 2 * 4 * 16 * 12


def test_per_rank_hook_leaves_a_plain_census_unchanged():
    """On plain tensors the census with the per-rank hook installed equals
    the bare dispatch mode's, op for op."""
    from repro_torch.roofline import hlo_analysis as H

    def step(a, b):
        return torch.softmax(a @ b, -1).sum()

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    bare = H._CensusMode()
    with bare:
        step(a, b)
    hooked = analyze(step, a, b)
    assert hooked.to_dict() == H._census(bare).to_dict()
    assert hooked.records == bare.records
