"""The port's copy of the AST linter (``repro_torch.analysis.ast_lints``)
against the reference's (``repro.analysis.ast_lints``): the same ``(code,
line)`` findings on every source case of ``tests/test_ast_lints.py`` and on
every file of ``src/repro``; and the port's own tree is lint-clean."""
import ast
import pathlib
import textwrap

import pytest

from repro.analysis import ast_lints as ref_lints
from repro_torch.analysis import ast_lints as port_lints

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_cases() -> list[tuple[str, str]]:
    """(test name, source) of every snippet the reference's lint tests lint."""
    tree = ast.parse((ROOT / "tests" / "test_ast_lints.py").read_text())
    cases = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in ("_lint", "_codes") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                cases.append((fn.name, textwrap.dedent(node.args[0].value)))
    return cases


CASES = _reference_cases()
REFERENCE_FILES = sorted((ROOT / "src" / "repro").rglob("*.py"))


def _findings(mod, source, path="<string>"):
    return [(f.code, f.line) for f in mod.lint_source(source, path)]


def test_the_reference_cases_were_found():
    assert len(CASES) >= 15


@pytest.mark.parametrize("name,source", CASES, ids=[c[0] for c in CASES])
def test_same_findings_on_the_reference_cases(name, source):
    assert _findings(port_lints, source) == _findings(ref_lints, source)


@pytest.mark.parametrize("path", REFERENCE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_same_findings_on_the_reference_tree(path):
    source = path.read_text()
    assert _findings(port_lints, source, str(path)) == _findings(ref_lints, source, str(path))


def test_port_tree_is_lint_clean():
    findings = port_lints.lint_paths(ROOT / "src" / "repro_torch")
    assert findings == [], [str(f) for f in findings]
