"""The benchmark's plain reference: each architecture's forward pass and
loss in plain PyTorch (one module an architecture, named by a
configuration's ``reference`` key), and a plain RANL round
(``ranl.py``).  Float32 arithmetic; TF32 is switched off by the caller
(``ranl.precision``).  Nothing here imports the program under test or
JAX.

An architecture module defines:

* ``param_specs(cfg)``: ``[(path, shape, init)]`` in the program's
  parameter layout, a path being a tuple of keys with the layer's index
  after ``"layers"``; ``init`` is ``("normal", std)`` or
  ``("const", value)``;
* ``loss(params, batch, cfg)``: the mean next-token cross-entropy of a
  batch ``{"tokens", "labels"}`` (B, S);
* ``matmul_params(cfg)`` and ``extra_flops(cfg, batch, seq)``: the
  parameters used in matrix products a token (a tied head once, an
  embedding lookup not at all) and the forward and backward FLOPs of a
  batch outside those products (attention's kept pairs, a recurrence),
  with nothing recomputed counted;
* ``kernel_shapes(cfg, batch, seq)``: the shapes at which the program's
  hand-written kernels of this architecture run for one worker.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The architecture module ``<name>.py`` beside this file."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference architecture {name!r} "
                                f"({path})")
    spec = importlib.util.spec_from_file_location(f"bench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
