"""The RANL round's own spans and host-sync counter (``obs.trace`` inside
``optim.ranl_llm.train_step``), on the CPU at the smoke size.

* a round under a tracer is bit for bit the round without one (params,
  state and metrics);
* the span tree of one round: ``ranl.round`` holds N
  ``ranl.worker_pass`` (each one ``forward`` and one ``backward``), then
  ``ranl.aggregate``, then ``ranl.newton``; inside the aggregate a
  ``ranl.memory_decode`` and a ``ranl.memory_encode`` a leaf where the
  memory is int8, and none where it is bf16 (the combine reads and
  writes the stored memory itself);
* ``host_syncs`` counts layers × N a round on a transformer (the
  ``torch.equal`` check in ``apply_attention``) and none on RWKV-6;
* a tracer that is not active records nothing;
* the shared clock: a ``record_function`` range opened inside a span lies
  within the span's ns interval on the profiler's clock.

The mesh path's case is a leg of ``tests/test_torch_train_sharded.py``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402, F401
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import init_model, lm_loss  # noqa: E402
from repro_torch.obs import Tracer, count, span, tracing  # noqa: E402
from repro_torch.optim import RanlLLMConfig, init_state, train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

N = 2
ARCHS = {"phi4-mini-3.8b": 1, "rwkv6-3b": 0}   # host_syncs a layer a worker
MEMORY = ("bf16", "int8")


def _round_inputs(arch, memory="bf16"):
    cfg = smoke_variant(get_config(arch))
    g = torch.Generator().manual_seed(0)
    params = init_model(cfg, g)
    batches = [make_batch(cfg, g, 2 * N, 16) for _ in range(2)]

    def loss_fn(p, b):
        return lm_loss(p, b, cfg)
    rcfg = RanlLLMConfig(num_workers=N, memory_int8=memory == "int8")
    state = init_state(params, loss_fn, batches[0], rcfg, prng.PRNGKey(0))
    return cfg, params, state, batches[1], loss_fn, rcfg


@pytest.fixture(scope="module", params=[(a, m) for a in sorted(ARCHS)
                                        for m in MEMORY],
                ids=lambda p: "-".join(p))
def traced_round(request):
    """(arch, memory, layers, the round's inputs, its outputs without a
    tracer, its outputs under one, the tracer)."""
    arch, memory = request.param
    cfg, params, state, batch, loss_fn, rcfg = _round_inputs(arch, memory)

    def step():
        return train_step(params, state, batch, prng.PRNGKey(3),
                          loss_fn=loss_fn, cfg=rcfg)
    plain = step()
    with tracing() as tr:
        traced = step()
    return arch, memory, cfg.num_layers, params, plain, traced, tr


def test_a_traced_round_is_bit_for_bit_the_round(traced_round):
    _, _, _, _, plain, traced, _ = traced_round
    (p0, s0, m0), (p1, s1, m1) = plain, traced
    for a, b in zip(leaves(p0), leaves(p1)):
        assert torch.equal(a, b)
    for k in ("precond", "memory"):
        for a, b in zip(leaves(s0[k]), leaves(s1[k])):
            if isinstance(a, dict):         # an int8 memory leaf
                assert a.keys() == b.keys(), k
                assert all(torch.equal(a[n], b[n]) for n in a), k
            else:
                assert torch.equal(a, b), k
    assert torch.equal(s0["step"], s1["step"])
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= \
        parent.end_ns


def test_the_round_span_tree_and_its_host_syncs(traced_round):
    arch, memory, layers, params, _, _, tr = traced_round
    spans = tr.spans
    rounds = [s for s in spans if s.name == "ranl.round"]
    assert len(rounds) == 1 and spans[-1] is rounds[0]
    rnd = rounds[0]
    assert all(_inside(s, rnd) for s in spans)
    passes = [s for s in spans if s.name == "ranl.worker_pass"]
    assert [dict(s.meta)["worker"] for s in passes] == list(range(N))
    for p in passes:
        inner = [s.name for s in spans if s is not p and _inside(s, p)]
        assert inner == ["forward", "backward"]
    assert len([s for s in spans if s.name == "forward"]) == N
    (agg,) = [s for s in spans if s.name == "ranl.aggregate"]
    (newton,) = [s for s in spans if s.name == "ranl.newton"]
    assert passes[-1].end_ns <= agg.start_ns and agg.end_ns <= \
        newton.start_ns
    # a codec pass a leaf runs only for the int8 memory
    n_codec = len(leaves(params)) if memory == "int8" else 0
    codec_names = {"ranl.memory_decode", "ranl.memory_encode"}
    for name in sorted(codec_names):
        codec = [s for s in spans if s.name == name]
        assert len(codec) == n_codec and all(_inside(s, agg)
                                             for s in codec)
    assert {s.name for s in spans} == {
        "ranl.round", "ranl.worker_pass", "forward", "backward",
        "ranl.aggregate", "ranl.newton"} | (codec_names if n_codec
                                            else set())
    assert tr.metrics.counter("host_syncs").value == ARCHS[arch] * layers * N
    assert all(s.device_s is None for s in tr.resolve())   # on the CPU


def test_a_tracer_not_active_records_nothing():
    cfg, params, state, batch, loss_fn, rcfg = _round_inputs(
        "phi4-mini-3.8b")
    tr = Tracer()
    with span("outside") as t:
        count("host_syncs")
        train_step(params, state, batch, prng.PRNGKey(3), loss_fn=loss_fn,
                   cfg=rcfg)
    assert t is None
    assert tr.spans == [] and tr.metrics.to_dict() == {}


def test_spans_lie_on_the_profilers_clock(tmp_path):
    """A ``record_function`` range opened inside a span falls within the
    span's ns interval on the profiler's clock (its Chrome export's
    ``baseTimeNanoseconds + 1000·ts``) to within 1 ms, and the tracer's
    own Chrome form puts the span where its ns interval says."""
    with tracing() as tr, profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    trace = json.loads((tmp_path / "prof.json").read_text())
    (ev,) = [e for e in trace["traceEvents"] if e.get("name") == "inner"]
    start = trace["baseTimeNanoseconds"] + 1000 * ev["ts"]
    end = start + 1000 * ev["dur"]
    (outer,) = tr.spans
    assert outer.start_ns - 1e6 <= start <= end <= outer.end_ns + 1e6
    mine = tr.chrome_trace()
    (own,) = mine["traceEvents"]
    assert abs(mine["baseTimeNanoseconds"] + 1000 * own["ts"]
               - outer.start_ns) < 1e3
    assert own["dur"] * 1000 == pytest.approx(outer.end_ns
                                              - outer.start_ns, abs=1)
