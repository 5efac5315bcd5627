"""The port stands alone: ``src/repro_torch/``, ``examples/torch_*.py`` and
``chip_smoke.py`` import neither JAX nor the reference package, and
importing the entry points (the serving front-ends, the ``Pixie`` facade,
the kernel packages, the preprocessor, the LM serving engine, the models,
the serving CLI, the fault injector, the heartbeat, the synthesis
front-end, the training path, the resource and roofline analysis and the
``examples/torch_*.py`` twins) pulls no JAX into the process.  (Only the
tests import both.)"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + EXAMPLES
              + [REPO / "chip_smoke.py"])
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    text = path.read_text(encoding="utf-8")
    offenders = [
        f"{path.relative_to(REPO)}:{text.count(chr(10), 0, m.start()) + 1}"
        for m in FORBIDDEN.finditer(text)
    ]
    assert not offenders, "the port may not import jax or repro: " + ", ".join(offenders)


def test_serving_entry_point_imports_without_jax():
    code = (
        "import sys\n"
        "import repro_torch.serve.fleet_frontend\n"
        "import repro_torch.kernels.vcgra\n"
        "import repro_torch.core.pixie\n"
        "import repro_torch.kernels.stencil\n"
        "import repro_torch.data\n"
        "import repro_torch.serve.engine\n"
        "import repro_torch.models\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.flash_attention.parity\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.serve.streaming\n"
        "import repro_torch.runtime.chaos\n"
        "import repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.core.synthesis\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.train\n"
        "import repro_torch.checkpoint\n"
        "import repro_torch.optim\n"
        "import repro_torch.data.tokens\n"
        "import repro_torch.core.analysis\n"
        "import repro_torch.roofline.hlo_analysis\n"
        "import importlib.util\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location(path.rsplit('/', 1)[-1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, *map(str, EXAMPLES)], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
