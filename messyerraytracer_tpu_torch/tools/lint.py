"""Convention linter of the port: the counterpart of the JAX package's
tools/lint.py, run over ``messyerraytracer_tpu_torch/`` and the port's
tests (``tests/test_torch_*.py``).

Rule families, mapped from the JAX package's to the port:

  header     every module starts with a docstring
  cite       every module's docstring cites its JAX counterpart (a path
             under ``messyerraytracer_tpu/`` or "the JAX package's
             <path>.py") or the reference's file:line
  module     layer boundaries, the JAX package's layers with the port's
             tooling on top: utils < {core, native} < {accel, kernels,
             scene} < dispatch < {render, api, debug, parallel} <
             {tools, demos}
  no-jax     the port imports torch and numpy, never jax: no ``import
             jax``, no ``jaxlib``, no ``messyerraytracer_tpu`` import, and
             no relative import that leaves the port's package (in place
             of the JAX package's ``no-torch``)
  docstring  public functions of 5 lines or more in core/ and kernels/
             carry docstrings
  naming     tests that import the port are ``tests/test_torch_*.py``
             (``*_helpers.py`` modules and conftest.py excepted);
             dataclasses are CamelCase
  f64        no float64 in the port's code: ``float64`` and ``.double``
             in code, not in strings or comments (a device performance
             trap; the deliberate uses are suppressed with their reason)

Suppressions, as in the JAX package: a line containing ``# lint: off`` is
skipped; a module docstring containing ``lint: skip-cite`` skips the cite
rule.

    python -m messyerraytracer_tpu_torch.tools.lint [--rule FAMILY] [--summary]

Exits 1 when any rule reports an issue.
"""

from __future__ import annotations

import argparse
import ast
import io
import re
import sys
import tokenize
from pathlib import Path

PKG_NAME = "messyerraytracer_tpu_torch"
# The JAX package's name, a match pattern only: it is matched against
# import names (JAX_MODULES) and cite paths (CITE_RE) in the text of linted
# modules, never imported and never opened as a path.  This is the one
# literal of that name the port's never-import-jax test allows
# (tests/test_torch_scene.py), and only in these uses.
JAX_PKG_NAME = "messyerraytracer_tpu"
ROOT = Path(__file__).resolve().parent.parent.parent

# layer order: lower may not import higher
LAYERS = {
    "utils": 0,
    "core": 1,
    "native": 1,
    "accel": 2,
    "kernels": 2,
    "scene": 2,
    "dispatch": 3,
    "render": 4,
    "api": 4,
    "debug": 4,
    "parallel": 4,
    "tools": 5,
    "demos": 5,
}

CITE_RE = re.compile(
    re.escape(JAX_PKG_NAME) + r"/[\w/]+\.py"
    r"|JAX package's\s+`*[\w/]+\.py"
    r"|\.(h|cpp|glsl|gd|md|py):\d+")
JAX_MODULES = ("jax", "jaxlib", JAX_PKG_NAME)
CAMEL_RE = re.compile(r"^_?[A-Z][A-Za-z0-9]*$")
SUPPRESS = "# lint: off"

ALL_FAMILIES = {
    "header", "cite", "module", "no-jax", "docstring", "naming", "f64",
}


class Lint:
    def __init__(self, root: Path):
        self.root = root
        self.errors: list[str] = []
        self.counts: dict[str, int] = {}

    def err(self, family: str, path: Path, line: int, msg: str):
        self.errors.append(
            f"{path.relative_to(self.root)}:{line}: [{family}] {msg}")
        self.counts[family] = self.counts.get(family, 0) + 1


def _imports(tree):
    """(line, module, relative level) of every import statement."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or "", node.level


def _is_jax(mod: str) -> bool:
    return any(mod == m or mod.startswith(m + ".") for m in JAX_MODULES)


def _f64_lines(src: str) -> list[int]:
    """Lines whose code (not strings or comments) names float64."""
    out = []
    prev = None
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.NAME and (
                tok.string == "float64"
                or (tok.string == "double" and prev == ".")):
            out.append(tok.start[0])
        if tok.type not in (tokenize.NL, tokenize.NEWLINE, tokenize.COMMENT):
            prev = tok.string
    return sorted(set(out))


def _dataclass_names(tree):
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for d in node.decorator_list:
            f = d.func if isinstance(d, ast.Call) else d
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name == "dataclass":
                yield node


def check_module(path: Path, pkg: Path, lint: Lint, families: set[str]):
    src = path.read_text()
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        lint.err("header", path, e.lineno or 1, f"syntax error: {e.msg}")
        return
    rel = path.relative_to(pkg)
    layer = rel.parts[0] if len(rel.parts) > 1 else None
    doc = ast.get_docstring(tree)

    def off(lineno):
        return lineno <= len(lines) and SUPPRESS in lines[lineno - 1]

    if "header" in families and path.name != "__init__.py" and not doc:
        lint.err("header", path, 1, "module docstring missing")

    if ("cite" in families and path.name != "__init__.py" and doc
            and "lint: skip-cite" not in doc and not CITE_RE.search(doc)):
        lint.err("cite", path, 1,
                 "module docstring cites neither its JAX counterpart nor a "
                 "reference file:line (add one or 'lint: skip-cite')")

    for lineno, mod, level in _imports(tree):
        if off(lineno):
            continue
        if "no-jax" in families:
            if level == 0 and _is_jax(mod):
                lint.err("no-jax", path, lineno, f"imports {mod}")
            elif level > len(rel.parts):
                lint.err("no-jax", path, lineno,
                         f"relative import {'.' * level}{mod} leaves "
                         f"{PKG_NAME}")
        if "module" in families and layer in LAYERS:
            target = None
            if level == 0 and mod.startswith(PKG_NAME + "."):
                target = mod.split(".")[1]
            elif level == 2 and len(rel.parts) == 2:
                target = mod.split(".")[0]
            if target in LAYERS and LAYERS[target] > LAYERS[layer]:
                lint.err("module", path, lineno,
                         f"layer '{layer}' imports higher layer '{target}'")

    if "docstring" in families and layer in ("core", "kernels"):
        for node in ast.iter_child_nodes(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not node.name.startswith("_")
                    and not off(node.lineno)
                    and (node.end_lineno or node.lineno) - node.lineno >= 5
                    and not ast.get_docstring(node)):
                lint.err("docstring", path, node.lineno,
                         f"public function '{node.name}' has no docstring")

    if "naming" in families:
        for node in _dataclass_names(tree):
            if not CAMEL_RE.match(node.name):
                lint.err("naming", path, node.lineno,
                         f"dataclass '{node.name}' is not CamelCase")

    if "f64" in families:
        for i in _f64_lines(src):
            if not off(i):
                lint.err("f64", path, i, "float64 in the port's code")


def check_tests(tests: Path, lint: Lint, families: set[str]):
    for path in sorted(tests.glob("*.py")):
        port_test = path.name.startswith("test_torch_")
        src = path.read_text()
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            lint.err("header", path, e.lineno or 1, f"syntax error: {e.msg}")
            continue
        if "header" in families and port_test and not ast.get_docstring(tree):
            lint.err("header", path, 1, "module docstring missing")
        if "naming" not in families or port_test:
            continue
        if path.name == "conftest.py" or path.name.endswith("_helpers.py"):
            continue
        if any(level == 0 and (mod == PKG_NAME
                               or mod.startswith(PKG_NAME + "."))
               for _, mod, level in _imports(tree)):
            lint.err("naming", path, 1,
                     f"a test of {PKG_NAME} not named test_torch_*.py")


def run(root: Path, families: set[str]) -> Lint:
    lint = Lint(root)
    pkg = root / PKG_NAME
    for path in sorted(pkg.rglob("*.py")):
        check_module(path, pkg, lint, families)
    if (root / "tests").is_dir():
        check_tests(root / "tests", lint, families)
    return lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rule", action="append",
                    help="run only this rule family (repeatable)")
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)
    families = set(args.rule) if args.rule else ALL_FAMILIES
    unknown = families - ALL_FAMILIES
    if unknown:
        print(f"unknown rule families: {sorted(unknown)}")
        return 2

    lint = run(ROOT, families)
    for e in lint.errors:
        print(e)
    if args.summary or lint.errors:
        total = sum(lint.counts.values())
        per = ", ".join(f"{k}={v}" for k, v in sorted(lint.counts.items()))
        print(f"-- lint: {total} issue(s) ({per or 'none'})")
    return 1 if lint.errors else 0


if __name__ == "__main__":
    sys.exit(main())
