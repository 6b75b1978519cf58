"""Quickstart on the PyTorch port: RANL (Algorithm 1) on a distributed
convex problem, on the CUDA card (``--device cpu`` runs on the host).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import PolicyConfig, make_quadratic, run_gd  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="default: the CUDA card; 'cpu' runs on the host")
args = ap.parse_args()
key = prng.PRNGKey(0)

# 16 heterogeneous workers, ill-conditioned objective (kappa = 500),
# region-aligned curvature, adaptive pruning: each worker trains a random
# ~50% of the 8 model regions each round, based on its "resources".
problem = make_quadratic(key, num_workers=16, dim=64, kappa=500.0,
                         coupling=0.0, num_regions=8, heterogeneity=0.0,
                         device=args.device)
policy = PolicyConfig(name="bernoulli", keep_prob=0.5, heterogeneous=True,
                      tau_star=1)

opts = repro_torch.RanlOptions(num_rounds=30, num_regions=8, policy=policy)
result = repro_torch.run(problem, key, engine="scan", options=opts,
                         device=args.device)
_, gd_dist = run_gd(problem, key, num_rounds=30)

print("round   RANL ||x-x*||^2      GD ||x-x*||^2    coverage")
d = result.dist_sq.cpu().numpy()
g = gd_dist.cpu().numpy()
for t in range(0, 31, 5):
    cov = float(result.coverage[t - 1]) if t else 1.0
    print(f"{t:5d}   {d[t]:16.3e}   {g[t]:16.3e}    {cov:.2f}")

print(f"\nRANL transmitted {float(result.comm_floats.double().mean()):.0f} "
      f"floats/round vs {problem.num_workers * problem.dim} dense "
      f"(pruned uplink).")
print(f"Minimum region coverage tau* observed: {result.tau_star}")

# Variance band across seeds: the batch engine carries the seeds on one
# axis, so 16 seeds are one run with one aggregation launch a round.
batch = repro_torch.run(problem, prng.split(key, 16), engine="batch",
                        options=opts, device=args.device)
finals = batch.dist_sq[:, -1].cpu().numpy()
tau = batch.tau_star.cpu().numpy()
print(f"\n16-seed final error band: median={np.median(finals):.2e} "
      f"[{finals.min():.2e}, {finals.max():.2e}], "
      f"tau* range {int(np.min(tau))}..{int(np.max(tau))}")
