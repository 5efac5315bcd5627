"""The example twins (``examples/torch_*.py``) run on the CPU.

Each twin of a reference example runs its reference's steps and
self-checks (bitwise outputs against the numpy oracles, the slot server
against the engine, the loss falling, the checkpoint read back) through
``main(argv)`` with ``--device cpu``, where the kernel wrappers compute
their plain versions, at its smallest size: ``--small`` where the twin
has it (it only shrinks sizes), and few steps for the training driver.
Without a card, the default ``--device cuda`` raises before any work.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
#: twin -> its CPU arguments (besides ``--device cpu``)
TWINS = {
    "torch_quickstart": ["--small"],
    "torch_pipeline_quickstart": ["--small"],
    "torch_fleet_quickstart": [],
    "torch_serve_lm": [],
    "torch_image_pipeline": [],
    "torch_train_lm": ["--small", "--steps", "40", "--batch", "2", "--seq", "32"],
}


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_reference_example_has_a_twin():
    refs = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.startswith("torch_")}
    assert {f"torch_{name}" for name in refs} == set(TWINS)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_its_checks_on_the_cpu(name, capsys):
    assert load(name).main(["--device", "cpu", *TWINS[name]]) == 0
    out = capsys.readouterr().out
    assert "[ok]" in out or "pipeline dispatches: 1" in out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        load(name).main(TWINS[name])
