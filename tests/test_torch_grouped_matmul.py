"""The grouped product of the expert layer (``kernels/grouped_matmul.py``)
and the layer around it, on the card: the CUDA kernels against
``torch.mm`` a group in f32 with TF32 off, forward and both backward
products, with empty groups, a group of every row and rows outside every
group; the dropless MoE layer's forward and backward with no host read
(``torch.cuda.set_sync_debug_mode("error")``) and against its plain
version on the CPU.  On the CPU: the wrapper refuses what the kernels do
not take.  No JAX here: the file runs on the card's host.

Tolerances: a tile sums K products in another order than cuBLAS, in
f32: within 1e-5 of the largest entry (K up to 2048; TF32's 10-bit
products miss that by two orders).  The rows outside
every group are exactly 0, and so is an empty group's weight gradient."""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kernels import grouped_matmul as GM  # noqa: E402
from repro_torch.models.moe import (apply_routed_moe,  # noqa: E402
                                    init_routed_moe)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = saved


def _offsets(sizes, device, start=0):
    o = [start]
    for n in sizes:
        o.append(o[-1] + n)
    return torch.tensor(o, dtype=torch.int32, device=device)


# (M, K, N, group sizes): ragged edges, an empty group, rows past the last
# group; one group of every row; rows before the first group (its start
# given first); the AFMoE cell's gate product, even and skewed
CASES = [(300, 40, 72, (17, 0, 130, 1, 64)),
         (256, 96, 48, (256,)),
         (420, 64, 132, ("start", 37, (50, 0, 129, 200))),
         (32768, 2048, 1024, "routed"),
         (32768, 1024, 2048, "skewed")]


def _case(M, K, N, sizes, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    start = 0
    if sizes in ("routed", "skewed"):   # 8192 routed rows over 32 experts
        share = torch.rand(32, generator=g, device=device)
        if sizes == "skewed":           # one expert takes a fifth
            share[7] = share.sum() / 4
        sizes = (share / share.sum() * 8192).long().tolist()
        sizes[3] = 0
    elif sizes[0] == "start":
        _, start, sizes = sizes
    x = torch.randn(M, K, generator=g, device=device)
    w = torch.randn(len(sizes), K, N, generator=g, device=device)
    dy = torch.randn(M, N, generator=g, device=device)
    return x, w, dy, _offsets(sizes, device, start)


def _plain(x, w, dy, offsets):
    b = offsets.tolist()
    y, dx = torch.zeros_like(dy), torch.zeros_like(x)
    dw = torch.zeros_like(w)
    for i in range(w.shape[0]):
        s, e = b[i], b[i + 1]
        y[s:e] = x[s:e] @ w[i]
        dx[s:e] = dy[s:e] @ w[i].T
        dw[i] = x[s:e].T @ dy[s:e]
    return y, dx, dw


def _close(got, want, rel=1e-5):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + 1e-30, err


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernels_equal_a_product_a_group(cuda, case):
    M, K, N, sizes = CASES[case]
    x, w, dy, offsets = _case(M, K, N, sizes, cuda)
    before = dict(LAUNCHES)
    y = GM.grouped_matmul(x, w, offsets)
    dx = GM.grouped_matmul_dx(dy, w, offsets)
    dw = GM.grouped_matmul_wgrad(x, dy, offsets, w.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_matmul"] == before["grouped_matmul"] + 1
    assert LAUNCHES["grouped_matmul_bwd"] == before["grouped_matmul_bwd"] + 2
    want = _plain(x, w, dy, offsets)
    for got, ref in zip((y, dx, dw), want):
        _close(got, ref)
    start, end = int(offsets[0]), int(offsets[-1])
    for outside in (slice(0, start), slice(end, M)):
        assert int(torch.count_nonzero(y[outside])) == 0
        assert int(torch.count_nonzero(dx[outside])) == 0
    b = offsets.tolist()
    for i in range(w.shape[0]):
        if b[i] == b[i + 1]:
            assert float(dw[i].abs().max()) == 0.0


@pytest.mark.gpu
def test_gradients_through_ops_on_the_card(cuda):
    x, w, dy, offsets = _case(*CASES[0], cuda, seed=1)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ops.grouped_matmul(xs, ws, offsets) * dy).sum().backward()
    _, dx, dw = _plain(x, w, dy, offsets)
    _close(xs.grad, dx)
    _close(ws.grad, dw)


def _layer_cfg():
    return ModelConfig(name="moe", family="moe", num_layers=1, d_model=256,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                       num_experts=8, router_experts=32, first_expert=8,
                       experts_per_token=4, score_func="sigmoid",
                       route_norm=True, route_scale=2.826, shared_d_ff=128,
                       dtype="float32")


@pytest.mark.gpu
def test_moe_layer_reads_nothing_back_to_the_host(cuda):
    cfg = _layer_cfg()
    params = init_routed_moe(cfg, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn(2, 512, 256, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)

    def run(p, x):
        p = {k: ({kk: vv.detach().requires_grad_() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.detach().requires_grad_())
             for k, v in p.items()}
        x = x.detach().requires_grad_()
        out, _ = apply_routed_moe(p, x, cfg)
        out.square().sum().backward()
        return out.detach(), x.grad, {k: v.grad for k, v in p.items()
                                      if not isinstance(v, dict)}
    run(params, x)                          # compiles the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dx, dp = run(params, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in params.items()}
    want, wdx, wdp = run(cpu, x.cpu())
    _close(out.cpu(), want, 1e-4)
    _close(dx.cpu(), wdx, 1e-4)
    assert dp["router"] is None and wdp["router"] is None   # held
    for k in ("gate", "up", "down"):
        _close(dp[k].cpu(), wdp[k], 1e-4)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    x, w = torch.zeros(4, 3), torch.zeros(2, 3, 5)
    offsets = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        GM.grouped_matmul(x, w, offsets)
    with pytest.raises(ValueError, match="CUDA"):
        GM.grouped_matmul_wgrad(x, torch.zeros(4, 5), offsets, 2)
    with pytest.raises(ValueError, match="offsets"):
        GM._check_offsets(offsets.long(), 2, x.device)
    with pytest.raises(ValueError, match="offsets"):
        GM._check_offsets(offsets[:2], 2, x.device)
