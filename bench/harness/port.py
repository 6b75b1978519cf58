"""Every call into the program under test: the PyTorch port
``repro_torch`` under ``src/`` of the checkout.  Its modules are looked
up when a call is made, so a test can break the timed path underneath
(and the traced run can wrap the layers ``train_step`` calls)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2] / "src"


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch.models
    import repro_torch.optim.ranl_llm
    return repro_torch


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from a configuration file: every key
    of the file that is one of its fields."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


class Program:
    """The program's RANL training step for one cell: the model
    configuration, the train CLI's loss (``models.lm_loss`` with its
    attention chunks) and ``RanlLLMConfig`` from the traffic file.  With
    ``mesh`` (the traffic's ``"mesh"``, a ("data",) mesh over the process
    group), the step's ``mesh=`` path, every collective logged by one
    ``Collectives`` recorder; ``workers`` are this rank's."""

    def __init__(self, cfg: dict, traffic: dict, device_type: str = "cuda"):
        rt = _import()
        self.rt = rt
        self.mcfg = model_config(cfg)
        seq = traffic["seq"]
        self.chunk = min(1024, seq)
        r = traffic["ranl"]
        m = traffic["masks"]
        self.rcfg = rt.optim.ranl_llm.RanlLLMConfig(
            num_workers=traffic["workers"], keep_prob=m["keep_prob"],
            heterogeneous=m["heterogeneous"], tau_star=m["tau_star"],
            mu=r["mu"], mu_rel=r["mu_rel"], lr=r["lr"],
            trust_ratio=r["trust_ratio"], memory_dtype=r["memory_dtype"])
        self.key = rt.prng.PRNGKey(0)    # unused: the masks are given
        self.on_mesh = {}
        self.workers = range(traffic["workers"])
        if "mesh" in traffic:
            from torch.distributed.device_mesh import init_device_mesh
            from repro_torch.core.collectives import Collectives
            n = traffic["mesh"]["data"]
            mesh = init_device_mesh(device_type, (n,),
                                    mesh_dim_names=("data",))
            self.coll = Collectives(mesh)
            self.on_mesh = {"mesh": mesh, "coll": self.coll}
            local = traffic["workers"] // n
            start = self.coll.rank("data") * local
            self.workers = range(start, start + local)

    def loss_fn(self, params, batch):
        return self.rt.models.lm_loss(params, batch, self.mcfg,
                                      q_chunk=self.chunk,
                                      kv_chunk=self.chunk)

    @property
    def ranl(self):
        return self.rt.optim.ranl_llm

    def init_state(self, params, batch):
        return self.ranl.init_state(params, self.loss_fn, batch, self.rcfg,
                                    self.key, **self.on_mesh)

    def step(self, params, state, batch, masks):
        """One round: (params, state, metrics)."""
        return self.ranl.train_step(params, state, batch, self.key,
                                    loss_fn=self.loss_fn, cfg=self.rcfg,
                                    masks=masks, **self.on_mesh)

    def launches(self) -> dict:
        """The program's kernel launch counters, as they stand."""
        from repro_torch.kernels import LAUNCHES
        return dict(LAUNCHES)
