"""The examples' PyTorch twins (``examples/torch_*.py``) run to their end on
the CPU at their smallest arguments, one case per twin, each in this
process through its ``main(argv)``.  The autoencoder twin runs its own
flat-plate session and then ``--producer spectral`` (the launcher's
path)."""

import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

CASES = {
    "torch_quickstart": [["--epochs", "1", "--sim-steps", "8"]],
    "torch_insitu_autoencoder": [
        ["--epochs", "1", "--sim-steps", "8"],
        ["--epochs", "1", "--sim-steps", "8", "--producer", "spectral"]],
    "torch_insitu_inference": [["--batch", "1", "--iters", "1",
                                "--image", "32"]],
    "torch_lm_train": [["--smoke", "--steps", "4", "--batch", "2",
                        "--seq-len", "32"]],
    "torch_insitu_lm_compression": [["--lm-steps", "4", "--ae-steps",
                                     "10"]],
}


def setup_module():
    import torch
    torch.set_num_threads(1)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_twin_is_listed():
    assert sorted(p.stem for p in EXAMPLES.glob("torch_*.py")) \
        == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_runs_on_the_cpu(name, capsys):
    mod = _load(name)
    for argv in CASES[name]:
        mod.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip(), name
