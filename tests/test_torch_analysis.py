"""Port parity, the resource analysis (the paper's Table I analogue):
``repro_torch.core.analysis`` against the reference's
``repro.core.analysis`` on the five components of the reference's
``benchmarks/resource_table.py``.

The reference censuses XLA's optimized HLO of its conventional overlay and
of the specialized executor; the port censuses the ATen ops its eager
interpreter and ``build_specialized_fn`` execute, each op once per element
it writes.  HLO instructions and ATen lane ops are different units, so no
count is held equal to the reference's.  What the two must share, per
component: the parameterized variant executes fewer ops, no more routing
ops and fewer FLOPs (the reference's own system test), and every reduction
percentage of the row has the reference's sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DFG as RefDFG
from repro.core import OverlayPlan as RefOverlayPlan
from repro.core import applications as ref_apps
from repro.core import compile_plan as ref_compile_plan
from repro.core import map_app as ref_map_app
from repro.core import paper_4x4 as ref_paper_4x4
from repro.core import sobel_grid as ref_sobel_grid
from repro.core.analysis import compile_and_census as ref_census
from repro.core.analysis import reduction_row as ref_reduction_row
from repro.core.grid import custom as ref_custom
from repro.core.specialize import build_specialized_fn as ref_specialized
from repro_torch.core.analysis import (
    CENSUS_BATCH, PAPER_LUT_REDUCTION_PCT, census_pair, compile_and_census, format_table,
    hlo_op_census, reduction_row, sass_counts, table_one_components,
)

COMPONENTS = {name: (grid, cfg) for name, grid, cfg in table_one_components()}
KEYS = ("total_ops", "routing_ops", "mux_ops", "arith_ops", "flops", "bytes")


def _ref_grid_and_dfg(name):
    """The reference's own build of component ``name``
    (``benchmarks/resource_table.py``)."""
    if name == "VC (8->4 routing)":
        g = RefDFG("vc_only")
        ins = [g.input(f"i{k}") for k in range(8)]
        for k in (3, 1, 6, 3):
            g.output(g.buf(ins[k]))
        return ref_custom("vc1", 8, [4], num_outputs=4), g
    if name.startswith("PE "):
        g = RefDFG("pe_only")
        a, b = g.input("a"), g.input("b")
        g.output(g.mul(a, b))
        return ref_custom("pe1", 2, [1], num_outputs=1, float_pe="floating" in name), g
    if name.startswith("4x4"):
        g = RefDFG("reduce8")
        ins = [g.input(f"i{k}") for k in range(8)]
        terms = [g.add(ins[i], ins[i + 1]) for i in range(0, 8, 2)]
        terms = [g.add(terms[0], terms[1]), g.add(terms[2], terms[3])]
        g.output(g.add(terms[0], terms[1]))
        return ref_paper_4x4(), g
    return ref_sobel_grid(), ref_apps.sobel_x()


@pytest.fixture(scope="module")
def rows():
    """``{component: (port row, reference row)}`` at the reference's batch."""
    out = {}
    for name, (grid, cfg) in COMPONENTS.items():
        ref_grid, dfg = _ref_grid_and_dfg(name)
        ref_cfg = ref_map_app(dfg, ref_grid)
        x = jnp.zeros((ref_grid.num_inputs, CENSUS_BATCH), ref_grid.dtype)
        conv = ref_census(lambda c, xx, g=ref_grid: ref_compile_plan(RefOverlayPlan(grid=g))(c, xx),
                          ref_cfg.to_jax(), x)
        spec = ref_census(ref_specialized(ref_grid, ref_cfg), x)
        out[name] = (reduction_row(name, *census_pair(grid, cfg)),
                     ref_reduction_row(name, conv, spec))
    return out


def test_components_are_the_references():
    """Each component maps to the reference's settings on a grid of the
    reference's shape."""
    for name, (grid, cfg) in COMPONENTS.items():
        ref_grid, dfg = _ref_grid_and_dfg(name)
        ref_cfg = ref_map_app(dfg, ref_grid)
        assert (grid.num_inputs, tuple(grid.pes_per_level), grid.num_outputs,
                grid.data_bits, grid.float_pe) == (
            ref_grid.num_inputs, tuple(ref_grid.pes_per_level), ref_grid.num_outputs,
            ref_grid.data_bits, ref_grid.float_pe), name
        for mine, theirs in zip(cfg.opcodes, ref_cfg.opcodes):
            np.testing.assert_array_equal(mine, theirs)
        for mine, theirs in zip(cfg.selects, ref_cfg.selects):
            np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(cfg.out_sel, ref_cfg.out_sel)
    assert set(PAPER_LUT_REDUCTION_PCT) == set(COMPONENTS)


@pytest.mark.parametrize("name", list(COMPONENTS))
def test_parameterized_uses_fewer_resources(rows, name):
    """The reference's system-level Table I claim, per component."""
    row, _ = rows[name]
    assert row["total_ops_param"] < row["total_ops_conv"]
    assert row["routing_ops_param"] <= row["routing_ops_conv"]
    assert row["flops_param"] < row["flops_conv"]


@pytest.mark.parametrize("name", list(COMPONENTS))
def test_reductions_have_the_references_sign(rows, name):
    row, ref_row = rows[name]
    for key in KEYS:
        got, want = row[f"{key}_reduction_pct"], ref_row[f"{key}_reduction_pct"]
        assert np.sign(got) == np.sign(want), (key, got, want)


def test_census_counts_lane_ops():
    """Each executed op counts once per element it writes, by category."""
    x = torch.zeros((3, 10), dtype=torch.int32)
    c = compile_and_census(lambda t: torch.where(t.index_select(0, torch.tensor([0, 2])) > 0,
                                                 t[:2], t[1:]), x)
    # routing: index_select and the two slices (views), 20 elements each;
    # arith: gt; mux: where
    assert c["mux_ops"] == 20
    assert c["arith_ops"] == 20
    assert c["routing_ops"] == 20 + 20 + 20
    assert c["flops"] == 40   # gt and where: one op per element
    assert hlo_op_census({"add_": 3, "where": 2, "cat": 1, "view": 4, "foo": 5}) == {
        "total_ops": 15, "routing_ops": 1, "mux_ops": 2, "arith_ops": 3, "move_ops": 4,
        "other_ops": 5}


def test_format_table_matches_the_reference(rows):
    from repro.core.analysis import format_table as ref_format_table

    table = [r for r, _ in rows.values()]
    assert format_table(table) == ref_format_table(table)


CUOBJDUMP = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN12_GLOBAL__N_120vcgra_batched_kernelIiLi0EEEvPKT_PKiPS1_lib
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
                                                                               /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                          /* 0x0000000000007919 */
        /*0020*/              @!P0 EXIT ;                                      /* 0x000000000000894d */
        /*0030*/                   BRA 0x30;                                   /* 0xfffffffc00fc7947 */
        /*0040*/                   NOP;                                        /* 0x0000000000007918 */
		..........

		Function : _ZN12_GLOBAL__N_119vcgra_pack_settingsIiEEvPKiS2_
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
"""
NVDISASM = """
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
	.elftype	@"ET_EXEC"
//--------------------- .text.vcgra_specialized  --------------------------
	.section	.text.vcgra_specialized,"ax",@progbits
	.sectioninfo	@"SHI_REGISTERS=16"
	.align	128
        .global         vcgra_specialized
        .type           vcgra_specialized,@function
vcgra_specialized:
.text.vcgra_specialized:
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2UR UR4, SR_CTAID.X ;
        /*0020*/                   IMAD.WIDE R2, R0, 0x4, R2 ;
        /*0030*/                   EXIT ;
.L_x_0:
        /*0040*/                   BRA `(.L_x_0);
        /*0050*/                   NOP;
        /*0060*/                   NOP;
"""


def test_sass_counts_reads_both_listings():
    counts = sass_counts(CUOBJDUMP)
    assert counts == {
        "_ZN12_GLOBAL__N_120vcgra_batched_kernelIiLi0EEEvPKT_PKiPS1_lib": 4,
        "_ZN12_GLOBAL__N_119vcgra_pack_settingsIiEEvPKiS2_": 2}
    assert sass_counts(NVDISASM) == {"vcgra_specialized": 5}


def test_kernel_census_raises_without_a_card():
    """No card, no census: B4's needs the built library and B5's a loaded
    module; neither is reported as 0."""
    from repro_torch.core.analysis import kernel_census
    from repro_torch.kernels.vcgra import SpecializedKernel

    grid, cfg = COMPONENTS["Sobel grid (45 PE, Fig.5)"]
    with pytest.raises(RuntimeError, match="loaded on a card"):
        kernel_census(SpecializedKernel(grid, cfg, device="cpu"))
    with pytest.raises(ValueError, match="no census"):
        kernel_census("vcgra_fused_batched", grid)
