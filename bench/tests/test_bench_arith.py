"""The benchmark's FLOP and byte arithmetic, pinned to hand-worked
values at the cells' shapes and to the bounds the port's ``chip_smoke.py``
reports at its train shapes."""

import json
import math
from types import SimpleNamespace

import pytest

from bench_helpers import BENCH

from harness import roofline, trace
from harness.cell import reader
from reference import load


def _config(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def _traffic(name):
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _params(cfg):
    return sum(math.prod(s) for _, s, _ in load(cfg["reference"]).param_specs(cfg))


@pytest.mark.parametrize("name,params,matmul", [
    ("phi4-mini-3.8b", 815_938_560, 815_923_200),
    ("rwkv6-3b", 506_652_288, 338_821_120)])
def test_parameter_counts(name, params, matmul):
    cfg = _config(name)
    assert _params(cfg) == params
    assert load(cfg["reference"]).matmul_params(cfg) == matmul


@pytest.mark.parametrize("name,mix,tflop", [
    ("phi4-mini-3.8b", "ranl.n4.s512", 20.13),
    ("rwkv6-3b", "ranl.n4.s512", 8.35),
    ("rwkv6-3b", "ranl.n12.s256", 6.26)])
def test_round_flops(name, mix, tflop):
    """6 × matmul params × 4096 tokens, plus the kept causal attention
    (phi4-mini, 0.077 TFLOP) or the wkv (rwkv6, 0.02 TFLOP); 3072 tokens
    at N = 12."""
    cfg = _config(name)
    got = reader("step_mfu_pct").round_flops(load(cfg["reference"]), cfg,
                                              _traffic(mix))
    assert got / 1e12 == pytest.approx(tflop, rel=2e-3)


@pytest.mark.parametrize("name,mix,gb", [
    ("phi4-mini-3.8b", "ranl.n4.s512", 29.37),
    ("rwkv6-3b", "ranl.n4.s512", 18.24),
    ("rwkv6-3b", "ranl.n12.s256", 50.67)])
def test_aggregate_bytes(name, mix, gb):
    """(8N + 4)·P: G read in f32, C read and C_new written in bf16, g
    written in f32."""
    cfg, traffic = _config(name), _traffic(mix)
    specs = load(cfg["reference"]).param_specs(cfg)
    got = reader("aggregate_roofline").aggregate_bytes(
        specs, traffic["workers"], traffic["ranl"]["memory_dtype"])
    assert got == (8 * traffic["workers"] + 4) * _params(cfg)
    assert got / 1e9 == pytest.approx(gb, rel=1e-3)


PEAK = {"flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("metric,which,shape,ms", [
    ("k3_roofline", "fwd_cost", (2, 512, 24, 8, 128), 0.04817),
    ("k3_roofline", "bwd_cost", (2, 512, 24, 8, 128), 0.1204),
    ("k4_roofline", "fwd_cost", (2, 512, 40, 64), 0.01644),
    ("k4_roofline", "bwd_cost", (2, 512, 40, 64), 0.03005)])
def test_kernel_bounds_match_chip_smoke(metric, which, shape, ms):
    """f32 at the train shapes: K3 bound by operations, K4's forward by
    bytes and its backward by operations, as PERF.md's kernel table."""
    got = roofline.bound_s(getattr(reader(metric), which)(*shape, 4),
                           PEAK) * 1e3
    assert got == pytest.approx(ms, rel=2e-3)


def test_kernel_names_pick_the_kernels_only():
    k3, k4 = reader("k3_roofline"), reader("k4_roofline")
    ops = {"void (anonymous namespace)::attn_kernel<float, 128>(...)": 1.0,
           "_ZN12_GLOBAL__N_19dq_kernelEv": 2.0,
           "void (anonymous namespace)::wkv_bwd_kernel<float, 64>(...)": 4.0,
           "void at::native::vectorized_elementwise_kernel<4>(...)": 8.0,
           "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16": 16.0}
    assert roofline.kernel_time(ops, k3.KERNELS) == 3.0
    assert roofline.kernel_time(ops, k4.KERNELS) == 4.0


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_device_pass_busy_is_the_union_of_device_intervals():
    events = [_x("k1", "kernel", 0, 10), _x("k2", "kernel", 5, 10),
              _x("copy", "gpu_memcpy", 30, 5), _x("aten::mm", "cpu_op", 0, 50),
              _x("k1", "kernel", 40, 10)]
    got = trace.device_summary(events, 100e-6)
    assert got["window_s"] == 100e-6
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["ops"] == pytest.approx({"k1": 20e-6, "k2": 10e-6,
                                        "copy": 5e-6})
    assert got["counts"] == {"k1": 2, "k2": 1, "copy": 1}


def test_host_pass_names_each_idle_gap_by_the_span_open_at_its_start():
    events = [_x(trace.WINDOW, "user_annotation", 0, 100),
              _x("bench.aggregate", "user_annotation", 0, 60),
              _x("aten::where", "cpu_op", 10, 20),
              _x("k", "kernel", 0, 10), _x("k", "kernel", 50, 30),
              _x("k", "kernel", 200, 10)]          # outside the window
    got = trace.host_gaps(events)
    assert got["host_window_s"] == pytest.approx(100e-6)
    assert got["host_busy_s"] == pytest.approx(40e-6)
    assert got["gaps"] == pytest.approx({
        "bench.aggregate / aten::where": 40e-6,
        "outside spans / no operator": 20e-6})
    assert trace.host_gaps([_x("k", "kernel", 0, 1)])["gaps"] == {}


@pytest.mark.parametrize("chips,idle", [(1, 20.0), (4, 50.0)])
def test_idle_share_divides_by_unprofiled_rounds_on_one_chip(chips, idle):
    """On one chip by the unprofiled rounds' time; on several by the
    device pass's own window, where a collective waits for its peers."""
    t = {"busy_s": 0.4, "window_s": 0.8, "plain_window_s": 0.5}
    got = reader("device_idle_pct").read(SimpleNamespace(chips=chips,
                                                         trace=t))
    assert got == pytest.approx(idle)
