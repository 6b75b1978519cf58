"""The port's kernels: the plain versions against the reference's oracles
and its Pallas kernels (interpret mode, as tests/test_kernels.py runs
them), the dispatch by device, and — on a card — the Triton kernels
against the plain versions.

Tolerances: C′ is a select, so it is bit-equal everywhere.  ḡ and x′ sum
N rows in another order than the reference (rtol 1e-4, atol 1e-5
against the reference, 1e-5/1e-6 kernel against plain on the card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import region_aggregate as K  # noqa: E402

SHAPES = [(1, 1), (3, 129), (7, 513)]
MASKS = ["random", "all_false", "all_true"]
MU, LR = 0.1, 0.7


def _inputs(n, d, kind, seed=0):
    rng = np.random.default_rng(seed + 31 * n + d)
    if kind == "random":
        m = rng.random((n, d)) < 0.5
    else:
        m = np.full((n, d), kind == "all_true")
    g = (rng.normal(size=(n, d)) * m).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=d).astype(np.float32)
    h = (np.abs(rng.normal(size=d)) + 0.01).astype(np.float32)
    return g, m, c, x, h


def _t(*arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.fixture
def reference():
    """The reference's oracles and Pallas dispatch, on the CPU.  Only
    these tests need the reference's framework, which a GPU host may
    lack."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_region_aggregate_matches_reference(reference, n, d, kind):
    jnp, jops, jref = reference
    g, m, c, _, _ = _inputs(n, d, kind)
    got = ref.region_aggregate_ref(*_t(g, m, c))
    for want in (jref.region_aggregate_ref(g, m, c),
                 jops.region_aggregate(jnp.asarray(g), jnp.asarray(m),
                                       jnp.asarray(c))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_ranl_update_matches_reference(reference, n, d, kind):
    jnp, jops, jref = reference
    g, m, c, x, h = _inputs(n, d, kind)
    got = ref.ranl_update_ref(*_t(x, h, g, m, c), mu=MU, lr=LR)
    for want in (jref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR),
                 jops.ranl_update(jnp.asarray(x), jnp.asarray(h),
                                  jnp.asarray(g), jnp.asarray(m),
                                  jnp.asarray(c), mu=MU, lr=LR)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_all_uncovered_steps_along_memory_mean():
    g, m, c, x, h = _inputs(4, 33, "all_false")
    xn, cn = ref.ranl_update_ref(*_t(x, h, g, m, c), mu=1e-3, lr=1.0)
    expect = x - c.sum(0) / 4 / np.maximum(h, 1e-3)
    np.testing.assert_allclose(xn.numpy(), expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cn.numpy(), c)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    g, m, c, x, h = _t(*_inputs(3, 40, "random"))
    before = dict(LAUNCHES)
    a = ops.region_aggregate(g, m, c)
    b = ref.region_aggregate_ref(g, m, c)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = ops.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    b = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_server_aggregate_runs_the_plain_version_on_the_host(use_kernel,
                                                             kind):
    """Both routes of the engine's aggregation reach the one plain
    definition for CPU tensors, bit for bit."""
    from repro_torch.core.aggregation import server_aggregate
    g, m, c, _, _ = _t(*_inputs(5, 77, kind))
    got = server_aggregate(g, m, c, use_kernel=use_kernel)
    want = ref.region_aggregate_ref(g, m, c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    g, m, c, x, h = _t(*_inputs(3, 40, "random"))
    with pytest.raises(ValueError, match="CUDA"):
        K.region_aggregate(g, m, c)
    with pytest.raises(ValueError, match="CUDA"):
        K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    with pytest.raises(ValueError):
        ops.region_aggregate(g.to("meta"), m.to("meta"), c.to("meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES + [(32, 4096), (32, 8192), (32, (1 << 16) + 37)])
def test_triton_kernels_match_plain_on_card(cuda, n, d, kind):
    g, m, c, x, h = _t(*_inputs(n, d, kind), device=cuda)
    before = dict(LAUNCHES)
    got = K.region_aggregate(g, m, c)
    want = ref.region_aggregate_ref(g, m, c)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    got = K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    want = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    assert LAUNCHES["region_aggregate"] == before["region_aggregate"] + 1
    assert LAUNCHES["ranl_update"] == before["ranl_update"] + 1


@pytest.mark.gpu
def test_triton_wrappers_check_inputs_on_card(cuda):
    g, m, c, x, h = _t(*_inputs(3, 40, "random"), device=cuda)
    with pytest.raises(TypeError):
        K.region_aggregate(g.double(), m, c)
    with pytest.raises(ValueError):
        K.region_aggregate(g, m[:, :20], c)
    with pytest.raises(ValueError, match="contiguous"):
        K.region_aggregate(g[:, ::2], m[:, ::2], c[:, ::2])
