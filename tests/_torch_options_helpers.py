"""Shared pieces of the round-option parity tests
(``tests/test_torch_options*.py``): ``repro_torch.run`` against
``repro.run`` on problems and cost models carried across with
``repro_torch.interop`` (the same arrays), keys as numpy.  Tolerances:

* integer traces (masks through coverage and comm_floats, max_stale,
  tau_star, tau_covered), ``comm_bytes``, ``round_time``, on-time sets,
  deadlines and delays are exact;
* the compressors, ``uplink_bytes``, ``quorum_split`` and the memory
  updates are bit-exact on the same inputs; sums over workers differ in
  order: rtol 1e-6 (the quorum sums: rtol 1e-5, ROADMAP Queue 3);
* ``xs`` within 2e-5·max|x| on the uncompressed and top-k paths (the
  scan and reference engines).  A lossy quantizer is discontinuous: the
  oracle's f32 products round apart from the reference's in the last
  bit, which now and then moves an int8 value across a rounding edge by
  one step (1/127 of the row's absmax) or a bf16 value by one ulp of
  bf16 (2⁻⁸), and error feedback carries that into later rounds.  So
  int8 runs are held to 5e-2·max|x| and bf16 runs to 1e-2·max|x|, the
  size of such steps through a κ ≈ 80 solve — and their compressors to
  bit-exactness on identical inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.core import make_logistic, make_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402

KEY = jax.random.PRNGKey(3)
TKEY = interop.key_from_numpy(np.asarray(KEY))
XS_TOL = {None: 2e-5, "topk:2": 2e-5, "int8": 5e-2, "bf16": 1e-2}


def carry(p):
    """The reference problem's leaves and scalars -> the port's problem."""
    if hasattr(p, "A"):
        kind, names = "quadratic", ("A", "b", "x_star")
        scalars = dict(grad_noise=p.grad_noise, hess_noise=p.hess_noise,
                       mu=p.mu, L_g=p.L_g)
    else:
        kind, names = "logistic", ("X", "y", "x_star")
        scalars = dict(lam=p.lam, grad_noise=p.grad_noise,
                       hess_noise=p.hess_noise, mu=p.mu, L_g=p.L_g)
    return interop.problem_from_arrays(
        kind, {n: np.asarray(getattr(p, n)) for n in names}, scalars,
        device="cpu")


def carry_cost(c):
    """The reference's CostModel -> the port's, through interop."""
    statics = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
               if f.name not in ("compute_rate", "bandwidth", "pod_bw")}
    return interop.cost_from_arrays(
        {"compute_rate": np.asarray(c.compute_rate),
         "bandwidth": np.asarray(c.bandwidth),
         "pod_bw": None if c.pod_bw is None else np.asarray(c.pod_bw)},
        statics, device="cpu")


def quad(**kw):
    return make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=48,
                          kappa=80.0, coupling=0.0, num_regions=6,
                          grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3,
                          **kw)


_PROBLEMS = {}


def problems(kind="quadratic"):
    """(reference problem, port problem), built once per kind."""
    if kind not in _PROBLEMS:
        jp = quad() if kind == "quadratic" else make_logistic(
            jax.random.PRNGKey(0), num_workers=8, per_worker=64, dim=24,
            grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3)
        _PROBLEMS[kind] = (jp, carry(jp))
    return _PROBLEMS[kind]


def assert_traces_equal(jr, tr, clock_rtol=0.0):
    """Integer traces and comm_bytes exact; round_time exact unless
    ``clock_rtol`` (the diurnal capacity's sin, which the reference's
    compiled scan evaluates an ulp apart from its eager ops)."""
    for f in ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes"):
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.dtype == want.dtype, f
        if f == "round_time" and clock_rtol:
            np.testing.assert_allclose(got, want, rtol=clock_rtol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tr.tau_star, tr.tau_covered) == (jr.tau_star, jr.tau_covered)


def assert_xs_close(jr, tr, tol):
    want = np.asarray(jr.xs)
    np.testing.assert_allclose(tr.xs.numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def both(engine="scan", scenario=None, kind="quadratic", controller=None,
         rounds=8, **kw):
    """The same run through repro.run and repro_torch.run; ``policy`` is
    a dict of PolicyConfig fields."""
    jp, tp = problems(kind)
    jc = tc = None
    if scenario is not None:
        jc = jscen.make_scenario(scenario, jax.random.PRNGKey(9), 8).cost
        tc = carry_cost(jc)
    pol = kw.pop("policy", {})
    opts = dict(num_rounds=rounds, num_regions=6, **kw)
    jr = repro.run(jp, KEY, engine=engine, cost=jc, controller=controller,
                   policy=JPolicy(**pol), **opts)
    tr = repro_torch.run(tp, TKEY, engine=engine, cost=tc,
                         controller=controller, device="cpu",
                         policy=TPolicy(**pol), **opts)
    return jr, tr


def agg_inputs(seed=0, n=6, d=24, q=4, max_delay=2):
    """Random gradients, masks, memory, error-feedback residuals and a
    quorum round's on-time set, delays and late buffer, as numpy."""
    rng = np.random.default_rng(seed)
    Mq = rng.random((n, q)) < 0.6
    rids = np.repeat(np.arange(q), d // q)
    Mx = Mq[:, rids]
    G = (rng.normal(size=(n, d)) * Mx).astype(np.float32)
    C = rng.normal(size=(n, d)).astype(np.float32)
    err = (0.1 * rng.normal(size=(n, d))).astype(np.float32)
    on = rng.random(n) < 0.6
    delays = np.where(on, 0, rng.integers(1, max_delay + 2, n)).astype(
        np.int32)
    late = rng.normal(size=(max_delay, d)).astype(np.float32)
    return G, Mx, C, err, on, delays, late, rids
