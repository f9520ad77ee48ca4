"""The port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports jax, jaxlib or the JAX package ``repro``
(``repro_torch`` itself is of course allowed), nor msgpack, which the
machine with the card does not have (the port's checkpoints carry their
own codec)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_rule_tells_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.models.layers")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.kernels")
    assert _forbidden("msgpack") and _forbidden("msgpack.fallback")
    assert not _forbidden("repro_torch.checkpoint") and not _forbidden("msgspec")


def test_files_exist():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
