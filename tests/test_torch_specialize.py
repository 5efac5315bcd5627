"""Port parity, specialization: ``repro_torch.core.specialize`` against the
reference's ``repro.core.specialize``, and the source the specialized
Hopper kernel (B5) is generated from.

Liveness must be identical and the eager specialized executor bitwise
equal to the reference's (int32, int16, float32), with and without baked
coefficients.  The generated CUDA source is checked as text here (it
compiles only on the card, where ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold the kernel against its plain version): it is
deterministic, emits exactly the live slots and folds every mux into
wiring.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core import for_dfg as r_for_dfg
from repro.core import map_app as r_map_app
from repro.core import specialize as r_spec
from repro.core.grid import sobel_grid as r_sobel_grid

from repro_torch.core import specialize as t_spec
from repro_torch.core.ops import UNARY_OPS, Op
from repro_torch.kernels.vcgra import specialized
from repro_torch.kernels.vcgra import vcgra_specialized_ref

from test_torch_core import (
    ALL_APP_NAMES, DTYPES, R_SHARED, assert_parity, port_config, port_grid, with_dtype,
)

SOBEL_APPS = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity"]


def app_grids():
    """(case id, app, reference grid): every app on its exact grid and on
    the conftest shared grid, the Sobel-grid apps on ``sobel_grid()``."""
    cases = []
    for name in ALL_APP_NAMES:
        dfg = r_apps.ALL_APPS[name]()
        cases.append((f"{name}-exact", name, r_for_dfg(dfg, shape="exact")))
        cases.append((f"{name}-shared", name, R_SHARED))
    cases += [(f"{name}-sobel", name, r_sobel_grid()) for name in SOBEL_APPS]
    return cases


APP_GRIDS = app_grids()


@pytest.mark.parametrize("case", APP_GRIDS, ids=[c[0] for c in APP_GRIDS])
def test_live_slots_match_reference(case):
    _, name, r_grid = case
    cfg = r_map_app(r_apps.ALL_APPS[name](), r_grid)
    assert t_spec._live_slots(port_grid(r_grid), port_config(cfg)) == \
        r_spec._live_slots(r_grid, cfg)


def channels(r_grid, cfg, dtype_name, n=97, seed=0):
    """Seeded ``[num_inputs, n]`` channels, const rows holding their
    coefficients as ``pack_inputs`` would, as a JAX array and a tensor."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 256, (r_grid.num_inputs, n)).astype(np.float64)
    for i, name in enumerate(cfg.input_order):
        if name in cfg.const_values:
            x[i] = cfg.const_values[name]
    _, _, jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x.astype(np.float32)).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("bake_consts", [False, True])
@pytest.mark.parametrize("dtype_name", ["int32", "int16", "float32"])
@pytest.mark.parametrize("name", ALL_APP_NAMES)
def test_build_specialized_fn_matches_reference(name, dtype_name, bake_consts):
    r_grid = with_dtype(r_for_dfg(r_apps.ALL_APPS[name](), shape="exact"), dtype_name)
    cfg = r_map_app(r_apps.ALL_APPS[name](), r_grid)
    jx, tx = channels(r_grid, cfg, dtype_name)
    want = r_spec.build_specialized_fn(r_grid, cfg, bake_consts)(jx)
    t_grid, t_cfg = port_grid(r_grid), port_config(cfg)
    got = t_spec.build_specialized_fn(t_grid, t_cfg, bake_consts)(tx)
    assert_parity(got, want, dtype_name)
    # B5's plain version computes the same function.
    assert_parity(vcgra_specialized_ref(t_grid, t_cfg, tx, bake_consts), want, dtype_name)


def test_baked_consts_override_the_channel_rows():
    """With ``bake_consts`` the coefficient rows of ``x`` are never read:
    garbage there changes nothing, as in the reference."""
    r_grid = r_for_dfg(r_apps.sobel_x(), shape="exact")
    cfg = r_map_app(r_apps.sobel_x(), r_grid)
    jx, tx = channels(r_grid, cfg, "int32")
    want = r_spec.build_specialized_fn(r_grid, cfg, bake_consts=True)(jx)
    consts = [i for i, n in enumerate(cfg.input_order) if n in cfg.const_values]
    tx[consts] = 12345
    t_grid, t_cfg = port_grid(r_grid), port_config(cfg)
    assert_parity(t_spec.build_specialized_fn(t_grid, t_cfg, True)(tx), want, "int32")
    assert_parity(vcgra_specialized_ref(t_grid, t_cfg, tx, True), want, "int32")


LINE = re.compile(r"^\s*const T (\w+) = (.*);$")
PE = re.compile(r"^pe\((\d+) /\* (\w+) \*/, (\w+), (\w+)\)$")


@pytest.mark.parametrize("bake_consts", [False, True])
@pytest.mark.parametrize("case", APP_GRIDS, ids=[c[0] for c in APP_GRIDS])
def test_generated_source_is_the_live_dataflow(case, bake_consts):
    _, name, r_grid = case
    cfg = r_map_app(r_apps.ALL_APPS[name](), r_grid)
    grid, t_cfg = port_grid(r_grid), port_config(cfg)
    src = specialized.generate_source(grid, t_cfg, bake_consts)
    # Deterministic: the same settings give the same text and digest.
    again = specialized.generate_source(grid, port_config(cfg), bake_consts)
    assert again == src
    assert specialized.source_digest(again) == specialized.source_digest(src)

    live = t_spec._live_slots(grid, t_cfg)
    regs = dict(m.groups() for m in map(LINE.match, src.splitlines()) if m)
    emitted = {k for k in regs if k.startswith("l")}
    assert emitted == {f"l{lvl}_{s}" for lvl in range(grid.num_levels) for s in live[lvl]}
    baked = t_spec.baked_consts(t_cfg) if bake_consts else {}
    inputs = specialized.live_inputs(grid, t_cfg)
    for i in inputs:
        assert (regs[f"x{i}"] == f"x[{i}LL * ldx + p]") == (i not in baked)
    assert {k for k in regs if k.startswith("x")} == {f"x{i}" for i in inputs}
    # Every mux folded to wiring: each PE's operands are the registers its
    # selects name, its opcode a literal; no settings array anywhere.
    assert "sel" not in src and "ops[" not in src
    for lvl in range(grid.num_levels):
        prefix = "x" if lvl == 0 else f"l{lvl - 1}_"
        for s in live[lvl]:
            op = Op(int(t_cfg.opcodes[lvl][s]))
            value = regs[f"l{lvl}_{s}"]
            if op == Op.NONE:
                assert value == "zero_value<T>()"
                continue
            code, op_name, a, b = PE.match(value).groups()
            assert (int(code), op_name) == (int(op), op.name)
            sa, sb = (int(v) for v in t_cfg.selects[lvl][s])
            assert a == f"{prefix}{sa}"
            assert b == (a if op in UNARY_OPS else f"{prefix}{sb}")
    outs = re.findall(r"y\[(\d+)LL \* n \+ p\] = (\w+);", src)
    last = grid.num_levels - 1
    assert outs == [(str(k), f"l{last}_{int(s)}") for k, s in enumerate(t_cfg.out_sel)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_generated_literals_are_the_packed_const_values(dtype_name):
    """A baked coefficient's literal has the bits of the value a packed
    const channel holds in the grid dtype."""
    _, _, _, tdt = DTYPES[dtype_name]
    for value in (-2.0, 0.0, 5.0, 16.0, 128.0):
        lit = specialized._literal(value, tdt)
        held = t_spec.const_value(value, tdt)
        if dtype_name == "float32":
            bits = int(re.search(r"0x([0-9a-f]{8})u", lit).group(1), 16)
            assert bits == int(held.view(torch.int32)) & 0xFFFFFFFF
        elif dtype_name == "bfloat16":
            bits = int(re.search(r"0x([0-9a-f]{4})", lit).group(1), 16)
            assert bits == int(held.view(torch.int16)) & 0xFFFF
        else:
            assert lit == f"({int(held)})"
    assert specialized._literal(-2.0 ** 31, torch.int32) == "INT32_MIN"


def test_kernel_on_the_cpu_compiles_nothing():
    r_grid = r_sobel_grid()
    cfg = port_config(r_map_app(r_apps.sobel_x(), r_grid))
    kernel = specialized.SpecializedKernel(port_grid(r_grid), cfg, device="cpu")
    assert kernel.handle is None and not kernel.cached
    assert kernel.num_channels == 18
    assert specialized.SpecializedKernel(port_grid(r_grid), cfg, True, "cpu").num_channels == 9
