"""The reference imports nothing of the program and no JAX, compared by
each import's top-level name whole (the port's name begins with the JAX
package's); nor does any harness module at import time."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "dvbs2rx_tpu", "dvbs2rx_tpu_torch"}


def _imports(path):
    """Top-level names of every absolute import, and the modules that
    relative imports reach inside ``rxbench``."""
    tree = ast.parse(path.read_text())
    out = set()
    pkg = path.relative_to(HERE.parent).parent.parts
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                out.add(node.module.split(".")[0])
            else:
                base = pkg[: len(pkg) - node.level + 1]
                out.add(".".join(base + tuple(
                    (node.module or "").split("."))).strip("."))
    return out


def _closure(start):
    """Every file the reference reaches through relative imports."""
    seen, todo = set(), list(start)
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in _imports(p):
            if not name.startswith("rxbench"):
                continue
            rel = Path(*name.split(".")[1:])
            for cand in (HERE / rel.with_suffix(".py"),
                         HERE / rel / "__init__.py"):
                if cand.exists():
                    todo.append(cand)
    return seen


def test_reference_imports_nothing_of_the_program():
    files = _closure(sorted((HERE / "reference").glob("*.py")))
    assert any(f.name == "scramblers.py" for f in files)
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & BANNED, (f, tops & BANNED)


@pytest.mark.parametrize("sub", ["txref", "metrics", "end_to_end"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for f in (HERE / sub).glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & BANNED, (f, tops & BANNED)


def test_harness_import_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import rxbench.run, "
            "rxbench.stimulus, rxbench.checker, rxbench.trace, "
            "rxbench.landing, rxbench.spec; "
            "rxbench.spec.driver('stream_scan'); "
            "import dvbs2rx_tpu_torch.rx.stream; "
            "from rxbench.run import forbidden_modules; "
            "print(forbidden_modules())" % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    from rxbench.run import FORBIDDEN

    assert "dvbs2rx_tpu_torch" not in FORBIDDEN
    assert {"jax", "dvbs2rx_tpu"} <= FORBIDDEN
