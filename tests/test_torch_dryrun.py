"""The dry run: ``repro_torch.launch.dryrun.lower_cell`` against the
reference's ``repro.launch.dryrun.lower_cell`` on reduced configs at small
shapes, cell by cell.

The shapes are cut (``SHAPES``): train 32 x 256, prefill 16 x 512, decode
16 x 8,192 (from 8,192 rows ``cache_specs`` splits the cache's sequence
over 'model', so B7's sequence-split entry runs) and ``long_500k`` 1 x
16,384.  Every process patches ``get_arch`` to ``configs.reduced`` and
``SHAPES`` to these; nothing else of either package changes.

Three kinds of subprocess start at once from one module-scoped fixture:

- the reference, once, on 512 forced host devices.  Its module is never
  imported into this process (its first line sets ``XLA_FLAGS``).  Its
  ``make_production_mesh`` is patched to ``AxisType.Auto`` axes in that
  subprocess only: jax 0.9 makes ``jax.make_mesh``'s axes ``Explicit``, on
  which the reference's ``with_sharding_constraint`` raises in every
  train and prefill cell (a fault of the reference, kept there);
- the port, twice: the one-pod cells in one fake world of 256 ranks, the
  two-pod cell in one of 512 (one world a process), which then asks for a
  one-pod cell and records the error;
- the port's CLI at full width on gemma-2b ``decode_32k`` into a temporary
  directory.

Held exactly: skip flags and reasons, ``attn_mode``, ``chips``, ``mesh``,
``params_total``/``params_active``, ``model_flops``, the argument bytes a
device (the inputs an output depends on: ``jax.jit`` drops the others),
and for prefill and decode the output bytes, to which XLA's
``output_size_in_bytes`` adds the output tuple's index table, 8 bytes a
leaf (the test adds them).  One shard is ragged: the two-pod MoE decode's
logits, 16 sequences over 32 data ranks, which XLA pads to one a rank and
DTensor splits as ``torch.chunk`` does (rank 0 holds one in both).
Per-rank FLOPs (the census's products against the reference's HLO dots)
within 0.5x-1.5x.
Collective bytes by kind are printed beside the reference's; all-gather
and all-reduce asserted > 0 wherever the reference's are.  The other kinds
are the partitioners' own choices: DTensor's redistributions never use
point-to-point sends (XLA's ``collective-permute``), and the port's plan
issues an all-to-all only where a redistribution moves a split from one
dim to another (its MoE runs each rank's experts on the whole batch and
sums the partial outputs, where XLA's partitioner exchanges tokens).  The
peak is at least the argument bytes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: (arch, shape, mesh) of every cell.
CELLS = [
    ("gemma-2b", "train_4k", "single"), ("gemma-2b", "prefill_32k", "single"),
    ("gemma-2b", "decode_32k", "single"), ("gemma-2b", "train_4k", "multi"),
    ("deepseek-moe-16b", "train_4k", "single"), ("gemma3-12b", "decode_32k", "single"),
    ("xlstm-1.3b", "decode_32k", "single"), ("paligemma-3b", "prefill_32k", "single"),
    ("gemma-2b", "long_500k", "single"), ("gemma3-12b", "long_500k", "single"),
    ("xlstm-1.3b", "train_4k", "single"),
    # hymba's decode MLP over 'model'; the MoE decode whose batch of 16
    # the 32 data ranks of two pods do not split
    ("hymba-1.5b", "decode_32k", "single"), ("hymba-1.5b", "long_500k", "single"),
    ("deepseek-moe-16b", "decode_32k", "multi"), ("qwen2-moe-a2.7b", "decode_32k", "multi"),
]
FLOPS_RATIO = (0.5, 1.5)

_SHAPES = """
SHAPES = {"train_4k": ShapeConfig("train_4k", 256, 32, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 512, 16, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 8192, 16, "decode"),
          "long_500k": ShapeConfig("long_500k", 16384, 1, "decode")}
"""

_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "src")
    import jax
    from repro.configs import ARCHS, ShapeConfig, reduced
    from repro.launch import dryrun
    """) + _SHAPES + textwrap.dedent("""
    dryrun.SHAPES = SHAPES
    dryrun.get_arch = lambda name: reduced(ARCHS[name])

    def make_production_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(jax.sharding.AxisType.Auto,) * len(shape))

    dryrun.make_production_mesh = make_production_mesh
    out = {}
    for cell in json.loads(sys.argv[2]):
        arch, shape, mesh = cell
        report, _ = dryrun.lower_cell(arch, shape, mesh == "multi")
        out["/".join(cell)] = report
    json.dump(out, open(sys.argv[1], "w"))
    """)

_PORT = textwrap.dedent("""
    import sys, json
    import repro_torch.configs as configs
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    """) + _SHAPES + textwrap.dedent("""
    configs.SHAPES = SHAPES
    configs.get_arch = lambda name: reduced(ARCHS[name])
    from repro_torch.launch import dryrun
    out = {}
    cells = json.loads(sys.argv[2])
    for cell in cells:
        arch, shape, mesh = cell
        report, compiled = dryrun.lower_cell(arch, shape, mesh == "multi")
        assert compiled is None
        out["/".join(cell)] = report
    if cells[-1][2] == "multi":
        try:
            dryrun.lower_cell("gemma-2b", "decode_32k", False)
            out["wrong_world"] = None
        except RuntimeError as e:
            out["wrong_world"] = str(e)
    json.dump(out, open(sys.argv[1], "w"))
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every cell through both packages and the port's CLI, all at once;
    returns (reference reports, port reports, the CLI's directory, its
    output)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    single = [list(c) for c in CELLS if c[2] == "single"]
    multi = [list(c) for c in CELLS if c[2] == "multi"]
    jobs = {
        "reference": [_REFERENCE, str(out / "reference.json"), json.dumps(single + multi)],
        "port_single": [_PORT, str(out / "port_single.json"), json.dumps(single)],
        "port_multi": [_PORT, str(out / "port_multi.json"), json.dumps(multi)],
    }
    procs = {name: subprocess.Popen([sys.executable, "-c", *args], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, args in jobs.items()}
    cli_dir = out / "cli"
    procs["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape",
         "decode_32k", "--out", str(cli_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=400)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} exited {p.returncode}:\n{logs[name][-4000:]}"
    ref = json.loads((out / "reference.json").read_text())
    port = {**json.loads((out / "port_single.json").read_text()),
            **json.loads((out / "port_multi.json").read_text())}
    return ref, port, cli_dir, logs["cli"]


def _leaves_out(arch: str) -> int:
    """Leaves of a serving step's output: logits, every cache leaf, lengths."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM
    from repro_torch.tree import leaves

    return 2 + len(leaves(LM(reduced(ARCHS[arch])).abstract_cache(1, 16)))


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_cell_matches_the_reference(runs, cell):
    ref, port, _, _ = runs
    want, got = ref["/".join(cell)], port["/".join(cell)]
    assert "error" not in got, got.get("error")
    assert got.get("skipped") == want.get("skipped")
    if want.get("skipped"):
        assert got == want
        return
    for key in ("arch", "shape", "mesh", "chips", "attn_mode", "params_total", "params_active",
                "model_flops"):
        assert got[key] == want[key], key
    gm, wm = got["memory_analysis"], want["memory_analysis"]
    assert gm["argument_size_in_bytes"] == wm["argument_size_in_bytes"]
    if cell[1] != "train_4k":
        assert gm["output_size_in_bytes"] + 8 * _leaves_out(cell[0]) == \
            wm["output_size_in_bytes"]
        assert gm["alias_size_in_bytes"] == (wm["alias_size_in_bytes"]
                                             if "decode" in cell[1] or "500k" in cell[1] else 0)
    assert gm["peak_bytes_per_device"] >= gm["argument_size_in_bytes"]
    assert got["peak_memory_per_device"] == gm["peak_bytes_per_device"]
    ratio = got["xla_cost_analysis_flops"] / want["flops_per_device"]
    lo, hi = FLOPS_RATIO
    print(f"{'/'.join(cell)}: per-rank FLOPs {got['xla_cost_analysis_flops']:.4g} against "
          f"{want['flops_per_device']:.4g} ({ratio:.3f}x); collectives "
          f"{got['coll_breakdown']} against {want['coll_breakdown']}")
    assert lo <= ratio <= hi, f"per-rank FLOPs {ratio:.3f}x the reference's"
    for kind in ("all-gather", "all-reduce"):
        if want["coll_breakdown"][kind] > 0:
            assert got["coll_breakdown"][kind] > 0, kind
    assert got["coll_breakdown"]["total"] > 0


def test_the_cli_writes_the_reference_key_set(runs):
    ref, _, cli_dir, log = runs
    assert "all requested cells passed" in log
    from repro_torch.launch.dryrun import cell_id

    path = cli_dir / (cell_id("gemma-2b", "decode_32k", "single", "baseline") + ".json")
    report = json.loads(path.read_text())
    assert "error" not in report
    assert set(report) == set(ref["gemma-2b/decode_32k/single"])
    assert report["chips"] == 256 and report["attn_mode"] == "head_dim"
    assert "-> ok" in log and "bottleneck" in log


def test_a_cell_in_another_world_raises(runs):
    _, port, _, _ = runs
    assert port["wrong_world"] and "512" in port["wrong_world"] and "256" in port["wrong_world"]


def test_cell_id_is_the_reference_rule():
    from repro_torch.launch.dryrun import cell_id

    assert cell_id("gemma-2b", "train_4k", "single", "baseline") == "gemma-2b__train_4k__single"
    assert cell_id("a", "b", "multi", "v2") == "a__b__multi__v2"


def _zoo(jobs: int = 8, reference: bool = False, cells=None) -> int:
    """The port's half alone, on every config of the zoo, reduced, at this
    module's cut shapes, on both meshes (or on ``cells``, ``arch/shape/mesh``
    names): one subprocess (one fake world) per cell, ``jobs`` at a time.
    Needs no JAX and no card; run with ``PYTHONPATH=src python
    tests/test_torch_dryrun.py``.  With ``reference`` (``--reference``;
    needs JAX) each cell's reference half runs too, in a subprocess of its
    own with this module's patches, and each line gains the per-rank FLOPs
    ratio, port over reference, flagged where it leaves ``FLOPS_RATIO``.
    Prints one line a cell and exits 1 if any cell of the port raised."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCHS

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    if cells:
        groups = [[c.split("/")] for c in cells]
    else:
        groups = [[[arch, shape, mesh]] for mesh in ("single", "multi") for arch in sorted(ARCHS)
                  for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]

    def run(cells, tmp):
        reports = []
        for name, program in [("port", _PORT)] + ([("ref", _REFERENCE)] if reference else []):
            path = Path(tmp) / ("_".join(cells[0]) + f".{name}.json")
            proc = subprocess.run([sys.executable, "-c", program, str(path), json.dumps(cells)],
                                  cwd=ROOT, env=env, capture_output=True, text=True)
            reports.append((proc, json.loads(path.read_text()) if proc.returncode == 0
                            else None))
        return cells, reports

    failed, out_of_band = 0, []
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(jobs) as pool:
        for cells, reports in pool.map(lambda c: run(c, tmp), groups):
            (proc, port), ref = reports[0], (reports[1] if reference else (None, None))
            name = "/".join(cells[0])
            if port is None:
                failed += 1
                print(f"FAILED {name}: {proc.stderr.strip()[-2000:]}")
                continue
            r = port[name]
            line = "skipped" if r.get("skipped") else (
                f"ok {r['t_lower_s']:.1f} s, {r['xla_cost_analysis_flops']:.4g} FLOPs, "
                f"peak {r['memory_analysis']['peak_bytes_per_device']:.4g} B")
            if reference:
                rproc, rrep = ref
                if rrep is None:
                    line += f"; the reference raised: {rproc.stderr.strip()[-300:]}"
                elif bool(rrep[name].get("skipped")) != bool(r.get("skipped")):
                    line += "; the reference's skip differs"
                    out_of_band.append(name)
                elif not r.get("skipped"):
                    ratio = r["xla_cost_analysis_flops"] / rrep[name]["flops_per_device"]
                    inside = FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1]
                    line += (f"; reference {rrep[name]['flops_per_device']:.4g} FLOPs, "
                             f"{ratio:.3f}x" + ("" if inside else " OUT OF BAND"))
                    if not inside:
                        out_of_band.append(name)
            print(name, line, flush=True)
    print(f"{len(groups) - failed} of {len(groups)} cells passed")
    if reference:
        print(f"{len(out_of_band)} outside {FLOPS_RATIO[0]}-{FLOPS_RATIO[1]}x of the reference: "
              f"{', '.join(out_of_band) or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=_zoo.__doc__.split(".")[0])
    parser.add_argument("--reference", action="store_true",
                        help="also run each cell's reference half and print the FLOPs ratio")
    parser.add_argument("--jobs", type=int, default=8)
    parser.add_argument("cells", nargs="*", help="arch/shape/mesh names (default: every cell)")
    args = parser.parse_args()
    sys.exit(_zoo(args.jobs, args.reference, args.cells))
