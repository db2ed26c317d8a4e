"""Python-level hazard lints the jaxpr can't see — the port's own copy of
``repro.analysis.ast_lints`` (the port imports nothing of the JAX package,
so it carries the linter; ``tests/test_torch_ast_lints.py`` holds the two
to the same findings on the reference's cases and on ``src/repro``).

Three hazards, each of which has bitten (or nearly bitten) a jax codebase:

* **AL001 — PRNG key reuse**: a key variable is passed to
  ``jax.random.split`` / ``fold_in`` (consuming it) and then reused as a key
  in a later ``jax.random.*`` call without being rebound. Reuse silently
  correlates "independent" draws.
* **AL002 — np. math on traced values**: a ``np.<mathfn>(...)`` call inside
  a jit-traced function whose arguments mention a formal parameter of that
  function. numpy silently calls back to host on tracers (ConcretizationError
  at best, a constant-folded wrong value at worst). np math on *static*
  config values is fine and not flagged.
* **AL003 — mutable default argument**: ``def f(x, cache={})`` shares one
  dict across calls; config objects accumulate state between runs.

Findings are suppressed per-line with ``# noqa: AL00x`` for audited,
intentional cases. The linter is deliberately first-order: it tracks names,
not values, and prefers a suppressible false positive over a silent miss.
The port's tree (``src/repro_torch``) is lint-clean under it.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

__all__ = ["LintFinding", "lint_source", "lint_file", "lint_paths"]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:  # gate report formatting
        return f"{self.path}:{self.line}: {self.code} {self.message}"


# np functions that do real math (vs. dtype constructors / static helpers)
_NP_MATH = frozenset(
    """sum mean dot matmul einsum exp log log1p expm1 sqrt square power abs
    maximum minimum clip where tanh sinh cosh sin cos tan prod cumsum cumprod
    std var argmax argmin argsort sort median quantile percentile outer trace
    tensordot cross diff gradient convolve corrcoef cov floor ceil round rint
    sign reciprocal divide multiply add subtract mod remainder""".split()
)

# jax entry points whose function-valued arguments get traced
_TRACING_ENTRY_POINTS = frozenset(
    """jit pmap vmap grad value_and_grad jacfwd jacrev hessian jvp vjp
    linearize checkpoint remat custom_jvp custom_vjp scan while_loop cond
    switch fori_loop map associative_scan shard_map pallas_call""".split()
)

# jax.random functions that take a key as their first argument
_KEY_CONSUMERS = frozenset({"split", "fold_in"})


def _noqa_lines(source: str) -> dict[int, set[str]]:
    """line number → set of suppressed codes (empty set = bare noqa)."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "# noqa" not in line:
            continue
        _, _, tail = line.partition("# noqa")
        codes = {c.strip() for c in tail.lstrip(": ").split(",") if c.strip()}
        out[i] = codes
    return out


class _ImportAliases(ast.NodeVisitor):
    """Map local names to fully dotted module paths (numpy, jax.random, …)."""

    def __init__(self) -> None:
        self.aliases: dict[str, str] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return
        for a in node.names:
            self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve a call target to a dotted path through the import aliases."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


def _collect_traced_functions(tree: ast.Module, aliases: dict[str, str]) -> set[ast.FunctionDef]:
    """Functions that get traced: jit-decorated, or passed (by name) into a
    jax tracing entry point anywhere in the module, plus functions nested
    inside one of those (closures trace with their parent)."""
    by_name: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            by_name.setdefault(node.name, []).append(node)

    def _is_tracing_target(call_fn: ast.AST) -> bool:
        dotted = _dotted(call_fn, aliases)
        if dotted is None:
            return False
        tail = dotted.rsplit(".", 1)[-1]
        return tail in _TRACING_ENTRY_POINTS

    traced: set[ast.FunctionDef] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _is_tracing_target(target):
                    traced.add(node)
                # functools.partial(jax.jit, ...) style decorators
                if isinstance(dec, ast.Call):
                    for arg in dec.args:
                        if _is_tracing_target(arg):
                            traced.add(node)
        elif isinstance(node, ast.Call) and _is_tracing_target(node.func):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    traced.update(by_name.get(arg.id, []))

    # closures defined inside a traced function trace with it
    grown = True
    while grown:
        grown = False
        for fn in list(traced):
            for node in ast.walk(fn):
                if isinstance(node, ast.FunctionDef) and node not in traced:
                    traced.add(node)
                    grown = True
    return traced


def _mentions_param(node: ast.AST, params: set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in params for n in ast.walk(node)
    )


def _function_params(fn: ast.FunctionDef) -> set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


class _FunctionLinter:
    """Per-function linear walk, in source order, for AL001/AL002."""

    def __init__(self, fn: ast.FunctionDef, aliases: dict[str, str],
                 traced: bool, findings: list, path: str,
                 params: set[str] | None = None) -> None:
        self.fn = fn
        self.aliases = aliases
        self.traced = traced
        self.findings = findings
        self.path = path
        # a closure sees its ancestors' (traced) parameters too
        self.params = _function_params(fn) if params is None else params
        self.consumed: dict[str, int] = {}  # key name → line it was consumed

    def run(self) -> None:
        for stmt in self.fn.body:
            self._visit(stmt)

    # -- helpers -----------------------------------------------------------

    def _random_fn(self, call: ast.Call) -> str | None:
        dotted = _dotted(call.func, self.aliases)
        if dotted is None:
            return None
        if ".random." in f".{dotted}" or dotted.startswith("jax.random"):
            return dotted.rsplit(".", 1)[-1]
        # `from jax.random import split` resolves to jax.random.split
        if dotted.startswith("random."):
            return dotted.rsplit(".", 1)[-1]
        return None

    def _np_math_fn(self, call: ast.Call) -> str | None:
        dotted = _dotted(call.func, self.aliases)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head != "numpy" and not dotted.startswith("numpy."):
            return None
        tail = dotted.rsplit(".", 1)[-1]
        return tail if tail in _NP_MATH else None

    def _rebind(self, target: ast.AST) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                self.consumed.pop(n.id, None)

    # -- linear traversal --------------------------------------------------

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are linted as their own functions
        if isinstance(node, ast.If):
            # exclusive branches: a consume in one arm must not poison the
            # other; afterwards only keys consumed in EVERY arm stay consumed
            self._visit(node.test)
            before = dict(self.consumed)
            self._visit_block(node.body)
            after_body = self.consumed
            self.consumed = dict(before)
            self._visit_block(node.orelse)
            after_else = self.consumed
            self.consumed = {
                k: v for k, v in after_body.items() if k in after_else
            }
            return
        if isinstance(node, ast.Assign):
            self._visit(node.value)
            for t in node.targets:
                self._rebind(t)
            return
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                self._visit(node.value)
            self._rebind(node.target)
            return
        if isinstance(node, ast.Call):
            for child in list(node.args) + [kw.value for kw in node.keywords]:
                self._visit(child)
            self._check_call(node)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _visit_block(self, stmts: list[ast.stmt]) -> None:
        for s in stmts:
            self._visit(s)

    def _check_call(self, call: ast.Call) -> None:
        rfn = self._random_fn(call)
        if rfn is not None and call.args:
            # only the first positional argument is the key (the rest are
            # counts / shapes / fold_in data)
            key_arg = call.args[0]
            if isinstance(key_arg, ast.Name):
                if key_arg.id in self.consumed:
                    self.findings.append(LintFinding(
                        self.path, call.lineno, "AL001",
                        f"PRNG key {key_arg.id!r} reused after being consumed "
                        f"by split/fold_in on line "
                        f"{self.consumed[key_arg.id]} — rebind the key or use "
                        f"a fresh subkey",
                    ))
                if rfn in _KEY_CONSUMERS:
                    self.consumed.setdefault(key_arg.id, call.lineno)
        nfn = self._np_math_fn(call)
        if nfn is not None and self.traced and _mentions_param(call, self.params):
            self.findings.append(LintFinding(
                self.path, call.lineno, "AL002",
                f"np.{nfn} applied to a traced argument inside a jitted "
                f"function — use jnp (np forces host concretization)",
            ))


def _lint_mutable_defaults(tree: ast.Module, findings: list, path: str) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in {"list", "dict", "set"}
            ):
                findings.append(LintFinding(
                    path, d.lineno, "AL003",
                    f"mutable default argument in {node.name}() — shared "
                    f"across calls; default to None and construct inside",
                ))


def lint_source(source: str, path: str = "<string>") -> list[LintFinding]:
    tree = ast.parse(source)
    imports = _ImportAliases()
    imports.visit(tree)
    aliases = imports.aliases
    traced = _collect_traced_functions(tree, aliases)
    findings: list[LintFinding] = []

    def _walk(node: ast.AST, outer_params: set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.FunctionDef):
                params = outer_params | _function_params(child)
                _FunctionLinter(
                    child, aliases, traced=child in traced,
                    findings=findings, path=path, params=params,
                ).run()
                _walk(child, params)
            else:
                _walk(child, outer_params)

    _walk(tree, set())
    _lint_mutable_defaults(tree, findings, path)
    noqa = _noqa_lines(source)
    return [
        f for f in findings
        if not (f.line in noqa and (not noqa[f.line] or f.code in noqa[f.line]))
    ]


def lint_file(path: str | pathlib.Path) -> list[LintFinding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), str(p))


def lint_paths(root: str | pathlib.Path) -> list[LintFinding]:
    """Lint every .py file under ``root`` (or the single file ``root``)."""
    p = pathlib.Path(root)
    files = [p] if p.is_file() else sorted(p.rglob("*.py"))
    findings: list[LintFinding] = []
    for f in files:
        findings.extend(lint_file(f))
    return findings
