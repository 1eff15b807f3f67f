"""k-stage executable pipeline + closed adaptive loop, end to end, on
the PyTorch port (the twin of ``examples/kway_adaptive.py``).

Deploys MobileNetV2 across the 3-stage pi→pi→gpu chain, streams batches
while the first hop degrades from healthy LAN to the paper's 200 ms /
5 Mbit WAN (a ``LinkTrace`` ramp the emulator samples per transfer), and
lets the closed loop — observed wire times → per-hop ``LinkEstimator`` →
``partitioner.solve`` → live migration — chase the moving optimum.
Stages compute on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_kway_adaptive.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import scenarios
from repro_torch.models.cnn import zoo
from repro_torch.runtime import AdaptiveRuntime

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

m = zoo.get("mobilenetv2").init(torch.Generator().manual_seed(0),
                                args.device)
x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
x = x.to(args.device)

# hop 0 ramps LAN → WAN; a quick ramp so the demo sees the full collapse
# (the registry's pi_pi_gpu_wan_ramp is the same shape at t=2..6s)
scen = scenarios.wan_ramp(scenarios.get("pi_pi_gpu"), hop=0,
                          t_start=0.5, t_end=2.0)
rt = AdaptiveRuntime(m, scen, graph=m.block_graph(input_hw=32),
                     batch=2, policy="throughput",
                     check_every=2, migration_cost_s=0.05, alpha=0.6,
                     device=args.device)
print(f"scenario {scen.name}: {scen.n_stages} stages, "
      f"links {[l.name for l in scen.links]}, device {rt.pipe.device}")
print(f"deployed at cuts {rt.pipe.cuts} (nominal conditions)\n")

for r in rt.run(lambda: x, n_batches=60):
    flag = "  << migrated" if r.migrated and r.migration_cost_s else ""
    print(f"t={r.t_s:6.2f}s batch {r.batch_idx:2d} cuts={r.cuts} "
          f"lat={r.latency_s*1e3:7.1f} ms "
          f"(model: {r.predicted_latency_s*1e3:7.1f} ms){flag}")

print(f"\ncut history: {' -> '.join(map(str, rt.cut_history))}")
g = rt.graph
print(f"hop-0 wire bytes/sample: {g.cut_bytes(rt.cut_history[0][0])}"
      f" -> {g.cut_bytes(rt.cut_history[-1][0])}")
rt.close()
