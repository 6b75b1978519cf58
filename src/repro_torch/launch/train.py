"""The train CLI: RANL (default) or the AdamW baseline.

Port of the reference's ``launch/train.py``: the same flags, checks and
printed lines, ending in one JSON line ``{"final_loss", "first_loss"}``.
Runs on the CUDA card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --steps 20 --batch 8 --seq 64 --workers 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --smoke

Parameters are random from a ``torch.Generator`` seeded with ``--seed``,
in f32, and the batches come from ``data.make_batch`` on the same
generator (other numbers than the reference's threefry batches).  The
round keys are the reference's (``prng``), so the masks, the simulated
clock of ``--scenario``/``--controller``/``--quorum`` and the region
allocation follow the reference's draws.  ``--journal PATH`` writes the
reference's run-journal schema (a header, one ``round`` record a step,
the spans, a summary; ``python -m repro_torch.obs.report PATH`` renders
it) and ``--trace PATH`` a Chrome trace of ``execute`` spans (one a
step, timed by CUDA events on the card), the round's own spans inside
each (``optim.ranl_llm.train_step``: the workers' forwards and
backwards, the aggregate (with its memory codec where the memory is
int8), the Newton step, the exchange) and the ``checkpoint`` span: the tracer is active over the
steps.
The port runs eagerly, so it has no ``lower``/``compile`` spans and no
compiled HLO for ``--dump-hlo`` to write.

``--data-shards``/``--model-shards``/``--pods`` above 1 train on a mesh
(``launch.mesh.make_engine_mesh``; ``--data-shards`` alone: a 1-D
``("data",)`` mesh), one process a rank, SPMD:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --smoke --data-shards 2

The CLI uses the process group it finds initialised, else initialises
one from torchrun's environment (NCCL on the card, gloo for ``--device
cpu``).  Workers and batch shard over ("pod", "data"), params and RANL
state over "model" (``optim.ranl_llm``); every rank builds the same
params and batches from ``--seed``.  Rank 0 alone prints and writes
``--journal``, ``--trace`` and ``--checkpoint-dir`` (a model-sharded
checkpoint is gathered to full leaves first).  ``--optimizer adamw``
under a mesh records the mesh in the journal header and runs the full
unsharded step on every rank, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import nullcontext

import torch

from .. import prng
from ..checkpoint import save
from ..configs import get_config, smoke_variant
from ..data import make_batch
from ..device import resolve_device
from ..models import init_model, lm_loss
from ..obs import Journal, Tracer, count, make_header, span, tracing
from ..optim import (AdamWConfig, RanlLLMConfig, adamw_init, adamw_step,
                     gather_tree, init_state, shard_params, train_step)
from ..optim.first_order import value_and_grad


def build_loss(cfg, q_chunk=1024, kv_chunk=1024):
    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg, q_chunk=q_chunk,
                       kv_chunk=kv_chunk)
    return loss_fn


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--optimizer", default="ranl",
                    choices=["ranl", "adamw"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--data-shards", type=int, default=1,
                    help="shard the worker/batch axes over this many "
                         "ranks")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="shard parameter/tensor axes over this many "
                         "ranks")
    ap.add_argument("--pods", type=int, default=1,
                    help="prepend a 'pod' axis to the mesh")
    ap.add_argument("--dump-hlo", default="", metavar="PATH",
                    help="the reference's compiled-HLO report; the port "
                         "compiles no HLO, so this exits")
    ap.add_argument("--scenario", default="",
                    help="named cluster scenario (repro_torch.hetero), "
                         "e.g. 'pareto-stragglers' or 'churn:period=5' — "
                         "prices every round under the per-worker cost "
                         "model, applies its availability dynamics to the "
                         "masks, and logs simulated wall-clock (sim_s)")
    ap.add_argument("--controller", default="",
                    help="closed-loop mask controller, e.g. "
                         "'resource:keep=0.7' or 'staleness-bounded:s=4' "
                         "— allocates each round's regions from the "
                         "previous round's telemetry instead of the "
                         "open-loop policy")
    ap.add_argument("--quorum", type=float, default=0.0,
                    help="semi-synchronous rounds: commit once this "
                         "fraction of regions has on-time coverage and "
                         "DROP late workers from the step. 0 = "
                         "synchronous. Needs --scenario/--controller")
    ap.add_argument("--quorum-tau", type=int, default=1,
                    help="per-region on-time coverage floor for "
                         "--quorum (0 = full participating coverage)")
    ap.add_argument("--compression", default="",
                    choices=["", "int8", "bf16"],
                    help="lossy uplink compression of the per-worker "
                         "gradients before the aggregate (RANL only; "
                         "empty = exact f32 wire)")
    ap.add_argument("--keep-prob", type=float, default=0.7)
    ap.add_argument("--mu", type=float, default=1e-4)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pattern", default="bigram",
                    choices=["bigram", "uniform"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--journal", default="", metavar="PATH",
                    help="write a structured run journal (JSONL, the "
                         "reference's schema): header + one record per "
                         "step + summary — render it with "
                         "'python -m repro_torch.obs.report PATH'")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="span-trace the run (execute/checkpoint; device "
                         "seconds from CUDA events on the card) and write "
                         "Chrome-trace JSON to PATH (open in Perfetto); "
                         "spans also land in the --journal when both are "
                         "set")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the host")
    return ap


def _check(args):
    """The reference's SystemExit checks, and the mesh's arithmetic."""
    if args.dump_hlo and args.optimizer != "ranl":
        raise SystemExit("--dump-hlo reports the RANL train step; rerun "
                         "with --optimizer ranl (the baseline optimizers "
                         "have no lowered step to analyze here)")
    if args.quorum and not (args.scenario or args.controller):
        raise SystemExit("--quorum needs the simulated cluster clock — "
                         "pass --scenario and/or --controller")
    if args.quorum and not 0.0 < args.quorum <= 1.0:
        raise SystemExit(f"--quorum {args.quorum} must be in (0, 1]")
    if (args.scenario or args.controller) and args.optimizer != "ranl":
        raise SystemExit("--scenario/--controller drive the RANL "
                         "region-mask loop; rerun with --optimizer ranl")
    if args.compression and args.optimizer != "ranl":
        raise SystemExit("--compression shapes the RANL uplink; rerun "
                         "with --optimizer ranl")
    if args.pods < 1:
        raise SystemExit(f"--pods {args.pods} must be >= 1")
    plane = args.pods * args.data_shards
    if _sharded(args) and args.workers % plane:
        raise SystemExit(
            f"num_workers={args.workers} must divide evenly across the "
            f"{plane}-way ('pod', 'data') mesh axes")
    if _sharded(args) and args.batch % args.workers:
        raise SystemExit(f"--batch {args.batch} must divide evenly across "
                         f"--workers {args.workers}")
    if args.dump_hlo:
        raise SystemExit("--dump-hlo: the PyTorch port runs eagerly and "
                         "compiles no HLO to write or analyze")


def _sharded(args) -> bool:
    return max(args.data_shards, args.model_shards, args.pods) > 1


def _mesh(args, device):
    """The run's mesh (None without a shard flag above 1), on the process
    group found initialised or else started from torchrun's environment;
    the reference's SystemExits where the ranks do not match."""
    if not _sharded(args):
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from .mesh import make_engine_mesh
    n = args.pods * args.data_shards * args.model_shards
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"mesh ({args.pods}, {args.data_shards}, "
                f"{args.model_shards}) needs {n} ranks but this is one "
                f"process; start one process a rank with torchrun "
                f"--nproc-per-node {n}")
        dist.init_process_group("nccl" if device.type == "cuda"
                                else "gloo")
    if args.pods > 1 or args.model_shards > 1:
        try:
            return make_engine_mesh(args.data_shards, args.model_shards,
                                    pods=args.pods,
                                    device_type=device.type)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if dist.get_world_size() != args.data_shards:
        raise SystemExit(
            f"--data-shards {args.data_shards} needs that many ranks but "
            f"the process group has {dist.get_world_size()}; start one "
            f"process a rank with torchrun --nproc-per-node "
            f"{args.data_shards}")
    return init_device_mesh(device.type, (args.data_shards,),
                            mesh_dim_names=("data",))


class _Hetero:
    """The closed-loop cluster simulation, host-side across steps: the
    controller's state and telemetry, each round's mask allocation, and
    the simulated clock."""

    def __init__(self, args, params, ko, device, say=print):
        from ..hetero import (initial_telemetry, make_controller,
                              make_scenario, uniform_cost)
        from ..optim import region_layout, region_param_counts
        self.args, self.device = args, device
        self.num_regions, _, _ = region_layout(params)
        scen = (make_scenario(args.scenario, prng.fold_in(ko, 71),
                              args.workers, device=device)
                if args.scenario else None)
        self.cost = scen.cost if scen else uniform_cost(args.workers, device)
        self.ctrl = make_controller(
            args.controller if args.controller
            else f"policy:keep={args.keep_prob}")
        self.sizes_q = region_param_counts(params)
        self.ctrl_state = self.ctrl.init_state(args.workers,
                                               self.num_regions, device)
        self.telem = initial_telemetry(args.workers, self.num_regions,
                                       device)
        self.sim_s = 0.0
        if scen:
            say(f"scenario: {scen.name} (controller "
                  f"{args.controller or 'policy shim'})")

    def _work(self, masks):
        return (masks * self.sizes_q[None, :]).sum(dim=1)

    def masks(self, ko, t):
        from ..hetero import available, quorum_split, worker_times
        kt = prng.fold_in(ko, t)
        masks, self.ctrl_state = self.ctrl.step(
            self.ctrl_state, self.telem, kt, t, self.args.workers,
            self.num_regions, self.device)
        masks = masks & available(self.cost, kt, t)[:, None]
        if self.args.quorum:
            # the round commits at the quorum deadline and late workers
            # sit it out (their regions ride the memory path)
            times = worker_times(self.cost, self._work(masks), t)
            deadline, on_time, _ = quorum_split(
                times, masks, quorum=self.args.quorum,
                quorum_tau=self.args.quorum_tau or None)
            masks = masks & on_time[:, None]
            self.deadline = float(deadline)
        return masks

    def observe(self, masks, t):
        from ..hetero import next_telemetry, worker_times
        work = self._work(masks)
        times = worker_times(self.cost, work, t)
        self.telem = next_telemetry(self.telem, masks.sum(dim=0), work,
                                    times)
        self.sim_round_s = (self.deadline if self.args.quorum
                            else float(times.max()))
        self.sim_s += self.sim_round_s
        self.max_stale = int(self.telem.stale_q.max())
        return (f" sim_s={self.sim_s:.0f} stale<={self.max_stale}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _local_device(device):
    """The card of this rank under torchrun (``LOCAL_RANK``)."""
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    return device


def run(argv=None):
    args = _parser().parse_args(argv)
    _check(args)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = resolve_device(args.device)
    if _sharded(args):
        device = _local_device(device)
    mesh = _mesh(args, device)
    main = mesh is None or mesh.get_rank() == 0
    say = print if main else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} over "
            f"{device.type}")
    _, _, ko = prng.split(prng.PRNGKey(args.seed), 3)
    g = torch.Generator(device=device).manual_seed(args.seed)

    params = init_model(cfg, g)
    loss_fn = build_loss(cfg, q_chunk=min(1024, args.seq),
                         kv_chunk=min(1024, args.seq))

    def next_batch():
        return make_batch(cfg, g, args.batch, args.seq, pattern=args.pattern)
    batch0 = next_batch()
    history = []
    journal = Journal(args.journal) if args.journal and main else None
    tracer = Tracer() if args.trace and main else None

    def header(engine, options, scenario=None, **extra):
        return make_header(engine=engine, options=options, mesh=mesh,
                           scenario=scenario,
                           extra={"arch": args.arch, "steps": args.steps,
                                  "batch": args.batch, "seq": args.seq,
                                  **extra})

    on_mesh = {}
    if args.optimizer == "ranl":
        rcfg = RanlLLMConfig(num_workers=args.workers,
                             keep_prob=args.keep_prob, mu=args.mu,
                             lr=args.lr,
                             compression=args.compression or None)
        hetero = (_Hetero(args, params, ko, device, say)
                  if args.scenario or args.controller else None)
        if mesh is not None:
            from ..core.collectives import Collectives
            from .mesh import model_shards
            from .shard import ranl_state_pspecs
            on_mesh = {"mesh": mesh, "coll": Collectives(mesh),
                       "pspecs": {"state": ranl_state_pspecs(
                           params, model_shards(mesh))}}
            params = shard_params(params, mesh, on_mesh["pspecs"])
        state = init_state(params, loss_fn, batch0, rcfg, ko, **on_mesh)
        if journal is not None:
            journal.write(header("train:ranl", rcfg,
                                 scenario=args.scenario or None,
                                 controller=args.controller or None,
                                 quorum=args.quorum or None))
    else:
        acfg = AdamWConfig(lr=1e-3)
        state = adamw_init(params, acfg)
        if journal is not None:
            journal.write(header("train:adamw", acfg))
    # the round's own spans and its host_syncs counter land in --trace
    with tracing(tracer) if tracer is not None else nullcontext():
        if args.optimizer == "ranl":
            for t in range(args.steps):
                batch = next_batch()
                masks = None if hetero is None else hetero.masks(ko, t)
                t0 = time.perf_counter()
                with span("execute", device=device, step=t):
                    params, state, metrics = train_step(
                        params, state, batch, ko, loss_fn=loss_fn,
                        cfg=rcfg, masks=masks, **on_mesh)
                sim_note = ("" if hetero is None
                            else hetero.observe(masks, t))
                if (journal is not None or t % args.log_every == 0
                        or t == args.steps - 1):
                    # one wait for every metric
                    vals = torch.stack([v.double()
                                        for v in metrics.values()])
                    count("host_syncs")
                    metrics = dict(zip(metrics, vals.tolist()))
                    metrics["step_s"] = time.perf_counter() - t0
                    if hetero is not None:
                        metrics["sim_round_s"] = hetero.sim_round_s
                        metrics["sim_s"] = hetero.sim_s
                        metrics["max_stale"] = hetero.max_stale
                    history.append(metrics)
                    if journal is not None:
                        journal.write({"kind": "round", "t": t + 1,
                                       **metrics})
                    if t % args.log_every == 0:
                        say(f"step {t:4d} loss={metrics['loss']:.4f} "
                            f"cov={metrics['coverage']:.2f} "
                            f"uplink={metrics['uplink_frac']:.2f} "
                            f"({metrics['step_s']:.2f}s){sim_note}")
        else:
            for t in range(args.steps):
                batch = next_batch()
                with span("execute", device=device, step=t):
                    loss, grads = value_and_grad(loss_fn, params, batch)
                    params, state = adamw_step(params, state, grads, acfg)
                del grads
                if (journal is not None or t % args.log_every == 0
                        or t == args.steps - 1):
                    count("host_syncs")
                    rec = {"loss": float(loss)}
                    history.append(rec)
                    if journal is not None:
                        journal.write({"kind": "round", "t": t + 1, **rec})
                    if t % args.log_every == 0:
                        say(f"step {t:4d} loss={rec['loss']:.4f}")
        if args.checkpoint_dir and on_mesh:
            params = gather_tree(params, **on_mesh)
        if args.checkpoint_dir and main:
            _sync(device)
            with span("checkpoint", device=device):
                save(params, args.checkpoint_dir, step=args.steps)
            say(f"saved checkpoint to {args.checkpoint_dir}")
    if journal is not None:
        if tracer is not None:
            for srec in tracer.span_records():
                journal.write(srec)
        journal.write({"kind": "summary", "rounds": args.steps,
                       "first_loss": history[0]["loss"],
                       "final_loss": history[-1]["loss"]})
        journal.close()
        say(f"wrote journal to {args.journal}")
    if tracer is not None:
        tracer.write_chrome(args.trace)
        say(f"wrote chrome trace to {args.trace}")
    say(json.dumps({"final_loss": history[-1]["loss"],
                    "first_loss": history[0]["loss"]}))
    return history


if __name__ == "__main__":
    run()
