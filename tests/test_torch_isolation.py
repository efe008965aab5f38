"""The PyTorch port stands alone: no module of ``paddle_tpu_torch``, nor
``chip_smoke.py`` or ``chip_ab.py``, imports ``jax``, ``ml_dtypes`` (it
comes with jax, and the card's machine has neither) or any module of
``paddle_tpu`` (only the tests import them). Checked on the source's
import statements, so a lazy import inside a function counts too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
BANNED = ("jax", "jaxlib", "ml_dtypes", "paddle_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(module):
    top = module.split(".")[0]
    return top in BANNED


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_what_it_must():
    assert _banned("jax.numpy") and _banned("paddle_tpu.serving")
    assert _banned("ml_dtypes")
    assert not _banned("paddle_tpu_torch.serving")
    src = "import jax\nfrom paddle_tpu.models import gpt\nimport torch\n"
    assert [m for m in _imported(ast.parse(src)) if _banned(m)] == \
        ["jax", "paddle_tpu.models"]
    assert any(p.name == "engine.py" for p in FILES)
