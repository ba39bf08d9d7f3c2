"""The port's protocol examples (``stark_rings_tpu_torch/examples/``)
run end to end on the CPU and print the line that
``tests/test_examples.py`` expects of each reference twin.  Each example
holds its own results against independent paths (the linalg oracle,
gadget recompose, the transcript replay, the verifier, the radix NTT),
so the line is printed only when those checks pass."""

import importlib

import pytest
import torch

# example -> the line its reference twin prints (tests/test_examples.py)
EXPECT = {
    "ajtai_commitment": "demo ok",
    "folding_step": "verifier transcript replay matches",
    "folding_tree": "REJECT on a tampered digit commitment",
    "bigring_fold": "square exact vs the radix oracle",
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_prints_its_line(name, capsys):
    mod = importlib.import_module(f"stark_rings_tpu_torch.examples.{name}")
    mod.main(device="cpu")
    out = capsys.readouterr().out
    assert EXPECT[name] in out, out
    assert "cpu" in out or name == "folding_step", out


def test_examples_default_to_the_card():
    """Without CUDA the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name in EXPECT:
        mod = importlib.import_module(f"stark_rings_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main()
