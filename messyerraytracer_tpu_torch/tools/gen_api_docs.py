"""Generate docs/API_torch.md, the rendered API reference of the port.

The port's counterpart of the JAX package's tools/gen_api_docs.py (which
writes docs/API.md for ``messyerraytracer_tpu``): every public module,
class, dataclass field block and function signature of
``messyerraytracer_tpu_torch``, with the first paragraph of its docstring,
extracted from the live package.  Importing the port touches no CUDA
device, so this runs on a machine without a card.

    python -m messyerraytracer_tpu_torch.tools.gen_api_docs           # rewrite
    python -m messyerraytracer_tpu_torch.tools.gen_api_docs --check   # stale?

``--check`` exits 1 when docs/API_torch.md differs from what the package
would generate (regenerate it whenever a public signature or docstring of
the port changes).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import sys

PACKAGE = "messyerraytracer_tpu_torch"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(_REPO, "docs", "API_torch.md")


def first_paragraph(doc: str | None) -> str:
    if not doc:
        return ""
    lines = []
    for ln in inspect.cleandoc(doc).splitlines():
        if not ln.strip() and lines:
            break
        if ln.strip():
            lines.append(ln.strip())
    return " ".join(lines)


def fmt_signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    return sig if len(sig) <= 100 else "(...)"


def _in_package(home) -> bool:
    return home == PACKAGE or str(home).startswith(PACKAGE + ".")


def public_members(mod):
    """(name, class or function) defined in the port, in ``__all__`` or
    definition order."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        home = getattr(obj, "__module__", None)
        if home is not None and not _in_package(home):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def render_class(name, cls, lines):
    lines.append(f"#### class `{name}`\n")
    p = first_paragraph(cls.__doc__)
    if p:
        lines.append(p + "\n")
    ann = getattr(cls, "__annotations__", {})
    if ann:
        lines.append("Fields: " + ", ".join(f"`{f}`" for f in ann) + "\n")
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_") or not callable(m):
            continue
        doc = first_paragraph(getattr(m, "__doc__", ""))
        lines.append(f"- `{mname}{fmt_signature(m)}`"
                     + (f" — {doc}" if doc else ""))
    lines.append("")


def generate() -> str:
    """The reference's text, from the live package."""
    pkg = importlib.import_module(PACKAGE)
    lines = [
        "# messyerraytracer_tpu_torch — API reference",
        "",
        "Generated by `python -m messyerraytracer_tpu_torch.tools."
        "gen_api_docs` — do not edit by hand.  The PyTorch/CUDA port's "
        "counterpart of docs/API.md (the JAX package's), extracted from the "
        "live package docstrings.",
        "",
        f"## Top-level exports (`import {PACKAGE}`)\n",
    ]
    for n, obj in public_members(pkg):
        kind = "class" if inspect.isclass(obj) else "def"
        doc = first_paragraph(obj.__doc__)
        sig = "" if inspect.isclass(obj) else fmt_signature(obj)
        lines.append(f"- **`{n}{sig}`** ({kind})"
                     + (f" — {doc}" if doc else ""))
    for n, value in vars(pkg).items():
        if not n.startswith("_") and isinstance(value, (int, float, str)):
            lines.append(f"- **`{n} = {value!r}`** (constant)")
    lines.append("")

    mods = sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              prefix=PACKAGE + ".")
        if not m.name.split(".")[-1].startswith("_"))
    for mname in mods:
        mod = importlib.import_module(mname)
        members = [(n, o) for n, o in public_members(mod)
                   if getattr(o, "__module__", mname) == mname]
        if not members:
            continue
        lines.append(f"## `{mname}`\n")
        p = first_paragraph(mod.__doc__)
        if p:
            lines.append(p + "\n")
        for n, obj in members:
            if inspect.isclass(obj):
                render_class(n, obj, lines)
            else:
                doc = first_paragraph(obj.__doc__)
                lines.append(f"#### `{n}{fmt_signature(obj)}`\n")
                if doc:
                    lines.append(doc + "\n")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if docs/API_torch.md is stale")
    args = ap.parse_args(argv)
    text = generate()
    rel = os.path.relpath(OUT, _REPO)
    if args.check:
        try:
            with open(OUT) as f:
                old = f.read()
        except FileNotFoundError:
            old = ""
        if old != text:
            print(f"{rel} is stale — run python -m {PACKAGE}.tools."
                  f"gen_api_docs")
            return 1
        print(f"{rel} up to date")
        return 0
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {rel}: {len(text.splitlines())} lines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
