"""The round options of ``repro_torch.run`` against ``repro.run``, part
one: compression with error feedback (parser, compressors, wire model,
aggregations, runs).  The quorum rounds and the low-rank [H]_μ init are
in ``test_torch_options_quorum.py``, the cluster scenarios and the
closed-loop controllers in ``test_torch_options_hetero.py``; the
problems, the comparisons and their tolerances in
``_torch_options_helpers``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import make_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from _torch_options_helpers import (  # noqa: E402
    KEY, TKEY, XS_TOL, agg_inputs, carry, assert_traces_equal,
    assert_xs_close, both)
from _torch_threads import one_torch_thread  # noqa: E402, F401


# --------------------------------------------------------------------------
# compression: parser, compressors, wire model, aggregations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "int8", "bf16", "topk:1", "topk:7"])
def test_parse_compression_specs_match(spec):
    want, got = jcomp.parse_compression(spec), tcomp.parse_compression(spec)
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.kind, got.k) == (want.kind, want.k)


@pytest.mark.parametrize("bad", ["gzip", "topk:0", "topk:-1", "topk:x",
                                 "int4"])
def test_parse_compression_rejects(bad):
    with pytest.raises(ValueError):
        tcomp.parse_compression(bad)
    with pytest.raises(ValueError):
        repro_torch.RanlOptions(compression=bad)


def test_options_validate_rank_and_quorum_knobs():
    for bad in (dict(hessian_rank=0), dict(quorum=0.0), dict(quorum=1.5),
                dict(quorum_tau=1), dict(gamma=1.5), dict(max_delay=0)):
        with pytest.raises(ValueError):
            repro_torch.RanlOptions(**bad)


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:1", "topk:3",
                                  "topk:9"])
@pytest.mark.parametrize("seed,shape,scale", [
    (0, (4, 30), 1.0), (1, (1, 30), 1e-3), (2, (3, 2, 30), 1e3),
    (3, (6, 30), 0.0)])
def test_compress_rows_bit_exact(spec, seed, shape, scale):
    """Each compressor on identical rows gives the reference's decoded
    rows bit for bit (round half to even, bf16 round to nearest even,
    top-k ties to the lower region), over a leading seed axis too."""
    Y = _rows(seed, shape, scale)
    rids = np.repeat(np.arange(6), 5)
    jc, tc = jcomp.parse_compression(spec), tcomp.parse_compression(spec)
    got = tcomp.compress_rows(tc, torch.tensor(Y), torch.tensor(rids), 6)
    for idx in np.ndindex(shape[:-2]):
        want = jcomp.compress_rows(jc, jnp.asarray(Y[idx]),
                                   jnp.asarray(rids), 6)
        np.testing.assert_array_equal(got[idx].numpy(), np.asarray(want))


def test_topk_ties_go_to_the_lower_region():
    """Equal energies: the lower-indexed regions survive, as lax.top_k's."""
    Y = np.ones((2, 12), np.float32)
    rids = np.repeat(np.arange(4), 3)
    got = tcomp.compress_rows(tcomp.parse_compression("topk:2"),
                              torch.tensor(Y), torch.tensor(rids), 4)
    want = jcomp.compress_rows(jcomp.parse_compression("topk:2"),
                               jnp.asarray(Y), jnp.asarray(rids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, :6].eq(1).all() and got[:, 6:].eq(0).all()


@pytest.mark.parametrize("spec", [None, "int8", "bf16", "topk:1", "topk:2",
                                  "topk:5"])
def test_uplink_bytes_wire_model_matches(spec):
    rng = np.random.default_rng(4)
    M = rng.random((3, 7, 4)) < 0.5
    M[0, 2] = False                                   # a silent worker
    sizes = np.array([10, 20, 30, 5], np.int32)
    got = tcomp.uplink_bytes(tcomp.parse_compression(spec), torch.tensor(M),
                             torch.tensor(sizes))
    for b in range(3):
        want = jcomp.uplink_bytes(jcomp.parse_compression(spec),
                                  jnp.asarray(M[b]), jnp.asarray(sizes))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_server_aggregate_matches(spec, seed):
    G, Mx, C, err, _, _, _, rids = agg_inputs(seed)
    want = jcomp.compressed_server_aggregate(
        jnp.asarray(G), jnp.asarray(Mx), jnp.asarray(C), jnp.asarray(err),
        jcomp.parse_compression(spec), region_ids=jnp.asarray(rids),
        num_regions=4)
    got = tcomp.compressed_server_aggregate(
        *map(torch.tensor, (G, Mx, C, err)), tcomp.parse_compression(spec),
        region_ids=torch.tensor(rids), num_regions=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("gamma,max_delay", [(0.5, 2), (1.0, 1), (0.0, 3)])
def test_compressed_quorum_aggregate_matches(spec, gamma, max_delay):
    G, Mx, C, err, on, delays, late, rids = agg_inputs(2, max_delay=max_delay)
    want = jcomp.compressed_quorum_aggregate(
        *map(jnp.asarray, (G, Mx, C, err, on, delays, late)),
        jcomp.parse_compression(spec), region_ids=jnp.asarray(rids),
        num_regions=4, gamma=gamma, max_delay=max_delay)
    got = tcomp.compressed_quorum_aggregate(
        *map(torch.tensor, (G, Mx, C, err, on, delays, late)),
        tcomp.parse_compression(spec), region_ids=torch.tensor(rids),
        num_regions=4, gamma=gamma, max_delay=max_delay)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# compression through the engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "reference"])
@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("scenario", [None, "pareto-stragglers:bw=64"])
def test_error_feedback_runs_match_reference(engine, spec, scenario):
    """Every compression kind with error feedback, synchronous rounds:
    integer traces and comm_bytes exact (on a finite uplink the bytes
    price round_time), xs within the kind's tolerance."""
    jr, tr = both(engine, scenario, compression=spec,
                  policy=dict(keep_prob=0.5, tau_star=1))
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, XS_TOL[spec])


def _pinned():
    """The reference's pinned compression problem (tests/test_compression)."""
    jp = make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=32,
                        kappa=50.0, coupling=0.0, num_regions=4)
    return jp, carry(jp)


def test_error_feedback_convergence_and_bytes():
    """As the reference's pin: compressed runs track the uncompressed one
    (int8/bf16 within 5 %, top-k within 50 %) and meter fewer bytes for
    the same floats; and each lands where the reference's lands."""
    jp, tp = _pinned()
    kw = dict(num_rounds=60, lr=0.5, num_regions=4)
    pol = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)
    res = {c: repro_torch.run(tp, TKEY, device="cpu", compression=c,
                              policy=TPolicy(**pol), **kw)
           for c in (None, "int8", "bf16", "topk:2")}
    d_none = float(res[None].dist_sq[-1])
    assert np.isfinite(d_none)
    assert float(res["int8"].dist_sq[-1]) <= 1.05 * d_none
    assert float(res["bf16"].dist_sq[-1]) <= 1.05 * d_none
    assert float(res["topk:2"].dist_sq[-1]) <= 1.5 * d_none
    b_none = float(res[None].comm_bytes.sum())
    for c, bound in (("int8", 0.5), ("bf16", 0.5 + 1e-9), ("topk:2", 1.0)):
        assert float(res[c].comm_bytes.sum()) < bound * b_none, c
        assert torch.equal(res[c].comm_floats, res[None].comm_floats)
        jr = repro.run(jp, KEY, compression=c, policy=JPolicy(**pol), **kw)
        assert_traces_equal(jr, res[c])


def test_compressed_quorum_path_converges():
    jp, tp = _pinned()
    kw = dict(num_rounds=60, lr=0.5, num_regions=4, quorum=0.75,
              quorum_tau=1, device="cpu",
              policy=TPolicy(keep_prob=0.5, tau_star=1, heterogeneous=False))
    d = {c: float(repro_torch.run(tp, TKEY, compression=c, **kw).dist_sq[-1])
         for c in (None, "int8")}
    assert np.isfinite(d[None]) and np.isfinite(d["int8"])
    assert d["int8"] <= 1.1 * d[None]


@pytest.mark.parametrize("spec", ["int8", "topk:2"])
@pytest.mark.parametrize("engine", ["scan", "reference"])
def test_compressed_quorum_runs_match_reference(spec, engine):
    jr, tr = both(engine, "pareto-stragglers", compression=spec, quorum=0.75,
                  quorum_tau=1, max_delay=2)
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, XS_TOL[spec])
