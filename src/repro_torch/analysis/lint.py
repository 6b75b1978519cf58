"""AST lint of the port: ``python -m repro_torch.analysis.lint [paths...]``
(default ``src/repro_torch``).  Standard library only.

Port of the reference's ``analysis/lint.py``, for the rules that carry
over to eager PyTorch:

- **RPL001 host-sync-in-round-loop** — no ``.item()``, ``.tolist()``,
  ``float(...)`` or ``int(...)`` inside a loop of the round loops
  ``core/ranl.py::_scan_rounds`` and ``core/sharded.py::
  _sharded_rounds``: on a card tensor each is a device-to-host copy that
  stalls the stream every round.  The counterpart of the reference's
  RPL001 (no host sync in a ``lax.scan`` body); the port has no scan, its
  rounds are these Python loops.
- **RPL003 eigh-confinement** — ``torch.linalg.eigh`` only in
  ``core/hessian.py``: the replicated O(d³) factorization the sharded
  paths must never reach.
- **RPL004 undeclared-mesh-axis** — a mesh-dimension literal (in
  ``mesh_dim_names=``, in the dimension argument of a ``Collectives``
  call or a mesh's ``get_group``/``get_local_rank``/``size``, and in
  ``axis_name``-style parameter defaults and keywords) must be one of
  ``DECLARED_AXES``, the names ``launch/mesh.py`` declares
  (``MESH_AXES``).
- **RPL005 bare-print** — no bare ``print`` in library code: only the
  ``launch/`` CLIs and ``obs/report.py`` print.

The reference's RPL002 (a non-frozen dataclass as a ``jit``-static
argument) has no counterpart: the port compiles nothing with static
arguments.
"""

from __future__ import annotations

import ast
import os
import sys
from dataclasses import dataclass

#: The mesh dimension names launch/mesh.py declares (``MESH_AXES``).
DECLARED_AXES = frozenset({"data", "model", "pod"})

AXIS_PARAM_NAMES = frozenset({"axis_name", "data_axis", "model_axis",
                              "pod_axis"})
# methods whose dimension argument is a mesh dimension: (name, position)
DIM_METHODS = {"all_reduce": 1, "all_gather": 1, "get_group": 0,
               "get_local_rank": 0, "group": 0, "rank": 0, "size": 0}
ROUND_LOOPS = {os.path.join("core", "ranl.py"): "_scan_rounds",
               os.path.join("core", "sharded.py"): "_sharded_rounds"}
EIGH_ALLOWED_SUFFIX = os.path.join("core", "hessian.py")
PRINT_ALLOWED_SUFFIX = os.path.join("obs", "report.py")
PRINT_ALLOWED_DIR = "launch"


@dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _dotted(node) -> str:
    """'torch.linalg.eigh' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _strings(node):
    """The string constants of a literal: itself, or a tuple/list's."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e for e in node.elts if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _host_syncs(path: str, tree) -> list[LintViolation]:
    """RPL001: host syncs inside a loop of a round-loop function."""
    name = next((fn for suffix, fn in ROUND_LOOPS.items()
                 if path.endswith(suffix)), None)
    out = []
    for fd in ast.walk(tree):
        if not (isinstance(fd, ast.FunctionDef) and fd.name == name):
            continue
        seen = set()
        for loop in ast.walk(fd):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                bad = None
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("item", "tolist"):
                    bad = f".{node.func.attr}()"
                elif _dotted(node.func) in ("float", "int"):
                    bad = f"{_dotted(node.func)}()"
                if bad:
                    out.append(LintViolation(
                        path, node.lineno, "RPL001",
                        f"{bad} inside the round loop of {name!r} — a "
                        f"device-to-host sync every round"))
    return out


def _axis(path, node, what) -> list[LintViolation]:
    return [LintViolation(path, s.lineno, "RPL004",
                          f"{what} {s.value!r} is not a declared mesh "
                          f"axis {sorted(DECLARED_AXES)}")
            for s in _strings(node) if s.value not in DECLARED_AXES]


def lint_file(path: str, tree: ast.Module) -> list[LintViolation]:
    violations = _host_syncs(path, tree)

    # RPL003: eigh confinement
    if not path.endswith(EIGH_ALLOWED_SUFFIX):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and _dotted(node).endswith("linalg.eigh")):
                violations.append(LintViolation(
                    path, node.lineno, "RPL003",
                    "linalg.eigh outside core/hessian.py — route through "
                    "the hessian module (the replicated O(d^3) chokepoint "
                    "the sharded paths must avoid)"))

    # RPL004: mesh dimension names
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg == "mesh_dim_names" or kw.arg in AXIS_PARAM_NAMES:
                violations += _axis(path, kw.value, f"{kw.arg}=")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in DIM_METHODS:
            pos = DIM_METHODS[node.func.attr]
            if len(node.args) > pos:
                violations += _axis(path, node.args[pos],
                                    f"{node.func.attr}() dimension")
            for kw in node.keywords:
                if kw.arg == "dim" and node.func.attr in ("all_reduce",
                                                          "all_gather"):
                    violations += _axis(path, kw.value,
                                        f"{node.func.attr}() dimension")
    for fd in ast.walk(tree):
        if not isinstance(fd, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = fd.args.args + fd.args.kwonlyargs
        defaults = ([None] * (len(fd.args.args) - len(fd.args.defaults))
                    + list(fd.args.defaults) + list(fd.args.kw_defaults))
        for arg, default in zip(args, defaults):
            if arg.arg in AXIS_PARAM_NAMES and default is not None:
                violations += _axis(path, default, f"default {arg.arg}=")

    # RPL005: bare print in library code
    if not _print_allowed(path):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                violations.append(LintViolation(
                    path, node.lineno, "RPL005",
                    "bare print() in library code — only the launch/ CLIs "
                    "and obs/report.py may print"))
    return violations


def _print_allowed(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return (PRINT_ALLOWED_DIR in parts[:-1]
            or path.endswith(PRINT_ALLOWED_SUFFIX))


def _collect_files(paths):
    files = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
    return sorted(set(files))


def lint_paths(paths) -> list[LintViolation]:
    violations = []
    for f in _collect_files(paths):
        with open(f) as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=f)
        except SyntaxError as e:
            violations.append(LintViolation(f, e.lineno or 0, "RPL000",
                                            f"syntax error: {e.msg}"))
            continue
        violations.extend(lint_file(f, tree))
    return violations


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    default = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [a for a in argv if not a.startswith("-")] or [default]
    violations = lint_paths(paths)
    for v in violations:
        sys.stdout.write(f"{v}\n")
    sys.stdout.write(f"repro_torch.analysis.lint: "
                     f"{len(_collect_files(paths))} file(s), "
                     f"{len(violations)} violation(s)\n")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
