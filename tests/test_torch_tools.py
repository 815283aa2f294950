"""The port's tooling: its convention lint (tools/lint.py) and its API
reference generator (tools/gen_api_docs.py), the counterparts of the JAX
package's tools/lint.py and tools/gen_api_docs.py.

The lint passes on the port and reports a seeded violation of each of its
rule families in a module of a scratch checkout; the committed
docs/API_torch.md is current and lists every name of the port's
``__init__``; and neither tool, nor the demo runner, imports jax."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from messyerraytracer_tpu_torch.tools import gen_api_docs, lint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# one module per family that breaks only that family (the path under
# messyerraytracer_tpu_torch/, its text)
CITE = '"""A module.\n\nPyTorch counterpart of messyerraytracer_tpu/x.py."""\n'
SEEDED = {
    "header": ("core/bad.py", "X = 1\n"),
    "cite": ("core/bad.py", '"""A module that cites nothing."""\n'),
    "module": ("core/bad.py", CITE + "from ..render import shade\n"),
    "no-jax": ("core/bad.py", CITE + "import jax.numpy as jnp\n"),
    "docstring": ("kernels/bad.py", CITE + "def f(x):\n" + "    x += 1\n" * 5
                  + "    return x\n"),
    "naming": ("core/bad.py", CITE + "import dataclasses\n\n\n"
               "@dataclasses.dataclass\nclass bad_rays:\n    n: int\n"),
    "f64": ("core/bad.py", CITE + "import torch\n\nX = torch.ones(2)"
            ".double()\n"),
}


def scratch_checkout(tmp_path, rel, text):
    pkg = tmp_path / lint.PKG_NAME
    (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
    (pkg / rel).write_text(text)
    (tmp_path / "tests").mkdir(exist_ok=True)
    return tmp_path


def test_lint_passes_on_the_port(capsys):
    assert lint.main(["--summary"]) == 0
    assert "-- lint: 0 issue(s) (none)" in capsys.readouterr().out


@pytest.mark.parametrize("family", sorted(SEEDED))
def test_lint_reports_a_seeded_violation(family, tmp_path):
    root = scratch_checkout(tmp_path, *SEEDED[family])
    found = lint.run(root, lint.ALL_FAMILIES)
    assert found.counts == {family: 1}, found.errors
    assert found.errors


@pytest.mark.parametrize("text", [
    CITE + "from ... import other\n",                 # leaves the package
    CITE + "from messyerraytracer_tpu.core import types\n",
    CITE + "import jaxlib\n",
])
def test_no_jax_reports_each_way_out(text, tmp_path):
    root = scratch_checkout(tmp_path, "core/bad.py", text)
    assert lint.run(root, {"no-jax"}).counts == {"no-jax": 1}


def test_suppressions_and_the_f64_rule_reads_code_only(tmp_path):
    text = (CITE + "import torch\n\n# float64 in a comment\n"
            "S = 'float64 in a string'\n"
            "X = torch.zeros(1, dtype=torch.float64)  # lint: off: why\n")
    root = scratch_checkout(tmp_path, "core/ok.py", text)
    scratch_checkout(tmp_path, "core/skip.py",
                     '"""A module.\n\nlint: skip-cite"""\n')
    assert lint.run(root, lint.ALL_FAMILIES).errors == []


def test_naming_of_the_port_tests(tmp_path):
    root = scratch_checkout(tmp_path, "core/ok.py", CITE)
    tests = root / "tests"
    (tests / "test_port_thing.py").write_text(
        '"""A test."""\nimport messyerraytracer_tpu_torch\n')
    (tests / "port_helpers.py").write_text(
        '"""Helpers."""\nimport messyerraytracer_tpu_torch\n')
    (tests / "test_torch_thing.py").write_text("import pytest\n")
    found = lint.run(root, lint.ALL_FAMILIES)
    assert sorted(found.errors) == [
        "tests/test_port_thing.py:1: [naming] a test of "
        "messyerraytracer_tpu_torch not named test_torch_*.py",
        "tests/test_torch_thing.py:1: [header] module docstring missing"]


def test_api_reference_is_current(capsys):
    assert gen_api_docs.main(["--check"]) == 0
    assert "up to date" in capsys.readouterr().out


def test_api_reference_lists_every_top_level_name():
    import inspect

    import messyerraytracer_tpu_torch as pkg

    text = Path(gen_api_docs.OUT).read_text()
    names = [n for n, v in vars(pkg).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    assert {"Rays", "make_rays", "generate_rays", "NO_HIT"} <= set(names)
    for n in names:
        assert f"- **`{n}" in text, n


def test_api_check_fails_on_a_stale_file(tmp_path, monkeypatch, capsys):
    stale = tmp_path / "API_torch.md"
    stale.write_text(Path(gen_api_docs.OUT).read_text() + "\nedited\n")
    monkeypatch.setattr(gen_api_docs, "OUT", str(stale))
    assert gen_api_docs.main(["--check"]) == 1
    assert "stale" in capsys.readouterr().out


def test_tools_and_demos_import_no_jax():
    """In one fresh process: the lint, the API generator and one demo of
    the gallery run and leave neither jax nor the JAX package imported."""
    code = (
        "import sys\n"
        "from messyerraytracer_tpu_torch.tools import gen_api_docs, lint\n"
        "from messyerraytracer_tpu_torch.demos import run_demos\n"
        "assert lint.main([]) == 0\n"
        "gen_api_docs.generate()\n"
        "assert run_demos.main(['--device', 'cpu', 'example']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'messyerraytracer_tpu')]\n"
        "assert not bad, bad\n"
        "print('no jax')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no jax" in out.stdout
