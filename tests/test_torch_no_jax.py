"""The port stands alone: no file of `cloud_tpu_torch/` nor
`chip_smoke.py` imports jax, flax, optax, the JAX package or
`transformers` (the card machine has none of them; the HF importers
read a model's `.config` and `.state_dict()`), and the port's entry
points default to the CUDA card."""

import ast
import os
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cloud_tpu", "transformers")


def _port_files():
    files = sorted((ROOT / "cloud_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "{} imports {}".format(path, bad)


def test_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy\nfrom cloud_tpu.ops import attention\n"
                     "import importlib\nimportlib.import_module('jax')\n")
    assert {"cloud_tpu", "jax"} <= set(_imported_roots(probe))


def test_default_device_is_cuda():
    from cloud_tpu_torch.parallel import runtime

    assert runtime.default_device() == torch.device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.resolve_device(None)


def test_entry_points_default_to_cuda():
    """Without device=, the model (and so the engine, scheduler and
    generate() it feeds) asks for the card; with no card that raises
    instead of quietly running on the CPU."""
    from cloud_tpu_torch.models import TransformerLM

    if torch.cuda.is_available():
        model = TransformerLM(vocab_size=16, num_layers=1, num_heads=2,
                              d_model=8, d_ff=16, max_seq_len=16)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TransformerLM(vocab_size=16, num_layers=1, num_heads=2,
                          d_model=8, d_ff=16, max_seq_len=16)
