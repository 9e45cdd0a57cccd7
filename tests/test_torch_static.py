"""Boundaries of the PyTorch port that hold without a card.

* No file of ``clip_tpu_torch/`` and no line of ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``clip_tpu``.
* ``chip_smoke.py`` exits nonzero and prints no result where no CUDA device
  is present, and in a directory that holds it and nothing else of the repo.
* A wrapper handed a CPU tensor runs its plain version; the CUDA build is
  never touched on import.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|clip_tpu)\b", re.M)


def _port_files():
    return sorted((ROOT / "clip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(path.read_text())]
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_should():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from clip_tpu.ops import nn")
    assert not _FORBIDDEN.search("from clip_tpu_torch.ops import nn")
    assert not _FORBIDDEN.search("from .ops import nn")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cpu_tensors_take_the_plain_versions():
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.ops import _cuda

    ops.reset_launches()
    x = torch.randn(5, 64)
    codes, sx = ops.lnq(x, torch.ones(64), torch.zeros(64), 1e-5)
    assert codes.dtype == torch.int8 and sx.shape == (5,)
    assert ops.launches()["lnq"] == 0 and _cuda._lib is None
