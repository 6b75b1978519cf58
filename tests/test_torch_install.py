"""An installed port can build its CUDA kernels: every header a source
under ``src/repro_torch/csrc/`` includes ships as package data, and
``kernels/build.py`` puts the libraries in a writable directory when it
lies outside a checkout.  No install is made: ``pyproject.toml`` is read
as text and ``build.py`` is loaded from copies with ``importlib``."""

import fnmatch
import importlib.util
import os
import re
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
BUILD_PY = os.path.join(PKG, "kernels", "build.py")


def _package_data_globs():
    """The ``repro_torch`` globs of ``[tool.setuptools.package-data]``."""
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    section = text.split("[tool.setuptools.package-data]", 1)[1]
    section = section.split("\n[", 1)[0]
    line = re.search(r"^repro_torch\s*=\s*\[(.*?)\]", section, re.M | re.S)
    assert line, section
    return re.findall(r'"([^"]+)"', line.group(1))


def test_every_included_header_ships_as_package_data():
    globs = _package_data_globs()
    csrc = os.path.join(PKG, "csrc")
    shipped = {os.path.join("csrc", n) for n in os.listdir(csrc)
               if any(fnmatch.fnmatch(os.path.join("csrc", n), g)
                      for g in globs)}
    included = set()
    for name in os.listdir(csrc):
        for inc in re.findall(r'#include\s+"([^"]+)"',
                              open(os.path.join(csrc, name)).read()):
            included.add(os.path.normpath(os.path.join("csrc", inc)))
    sources = {os.path.join("csrc", n) for n in os.listdir(csrc)
               if n.endswith(".cu")}
    assert included, "no source includes a local header"
    assert included | sources <= shipped, sorted(
        (included | sources) - shipped)


def _load_copy(dest):
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    shutil.copy(BUILD_PY, dest)
    spec = importlib.util.spec_from_file_location("_build_copy", dest)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _writable_outside(path, prefix):
    path = os.path.abspath(path)
    assert not path.startswith(os.path.abspath(prefix) + os.sep), path
    probe = path
    while not os.path.exists(probe):
        probe = os.path.dirname(probe)
    assert os.access(probe, os.W_OK), probe


@pytest.mark.parametrize("where", ["env", "cache"])
def test_an_installed_build_module_builds_in_a_writable_directory(
        tmp_path, monkeypatch, where):
    """``build.py`` loaded from ``<prefix>/lib/python3.X/site-packages/
    repro_torch/kernels/`` builds under ``$REPRO_TORCH_BUILD_DIR`` when
    set, else under the user's cache; never inside the prefix."""
    prefix = tmp_path / "prefix"
    dest = (prefix / "lib" / "python3.12" / "site-packages" / "repro_torch"
            / "kernels" / "build.py")
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if where == "env":
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kb"))
        want = tmp_path / "kb"
    else:
        want = tmp_path / "cache" / "repro_torch" / "kernels"
    mod = _load_copy(str(dest))
    assert mod.BUILD_DIR == want
    _writable_outside(mod.BUILD_DIR, prefix)


def test_a_checkout_builds_in_its_build_directory(tmp_path, monkeypatch):
    """In a checkout (``<root>/src/repro_torch`` beside ``pyproject.toml``)
    the libraries go to ``<root>/build/kernels``, whatever the
    environment says; the repo's own module does the same."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "elsewhere"))
    root = tmp_path / "checkout"
    (root / "src").mkdir(parents=True)
    (root / "pyproject.toml").write_text("[project]\n")
    mod = _load_copy(str(root / "src" / "repro_torch" / "kernels"
                         / "build.py"))
    assert mod.BUILD_DIR == root / "build" / "kernels"
    from repro_torch.kernels import build
    assert build.BUILD_DIR == build.build_dir() == \
        Path(ROOT) / "build" / "kernels"
