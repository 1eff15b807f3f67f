"""ServeGate end to end on the PyTorch port (the twin of
``examples/serving_gateway.py``): 8 tenants with mixed SLOs through one
pipeline.

Eight closed-loop tenants (SLOs from 150 ms to 2 s, the
``octet_mixed_slo`` mix) share the 3-stage pi→pi→gpu chain through one
:class:`~repro_torch.runtime.serve.Gateway` while hop 0 rides the
``congestion_spike`` trace — clean until t=2 s, fully congested (the
paper's 200 ms / 5 Mbit duress) by t=4 s, recovered by t=7 s.

Three control loops are visible in the printed timeline:

  * **micro-batching** — the gateway coalesces up to 8 tenant requests
    per padded micro-batch (occupancy column);
  * **SLO-aware admission** — the congestion dip blows the strict
    tenants' SLOs, the AIMD window halves (throttle), and clean batches
    after recovery grow it back (the ``win`` column);
  * **fleet-level Pareto control** — the :class:`FleetController`
    aggregates per-request QoS into fleet objectives and steers the
    splitter's policy axis (latency-min under tail pressure,
    throughput-max with headroom).

Stages compute on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serving_gateway.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import scenarios
from repro_torch.core.autosplit import AdaptiveSplitter
from repro_torch.models.cnn import zoo
from repro_torch.runtime import (EdgePipeline, FleetController, Gateway,
                                 drain_violations)

T_END, WINDOW_S = 9.0, 1.0
MAX_BATCH = 8

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

m = zoo.get("mobilenetv2").init(torch.Generator().manual_seed(0),
                                args.device)
scen = scenarios.with_trace(scenarios.get("pi_pi_gpu"), "congestion_spike")
mix = scenarios.get_tenant_mix("octet_mixed_slo")
print(f"scenario {scen.name}: {scen.n_stages} stages; "
      f"tenants {[f'{t.name}@{t.slo_s * 1e3:.0f}ms' for t in mix.tenants]}")

graph = m.block_graph(input_hw=32)
splitter = AdaptiveSplitter(graph, scen, batch=MAX_BATCH,
                            policy="throughput", hysteresis=0.10,
                            migration_cost_s=0.05, include_io=False,
                            amortize_horizon_s=30.0)
splitter.current = splitter.solve()
ctrl = FleetController(splitter, check_every=8, probe=False)

pipe = EdgePipeline(m, splitter.current.partition, scen, device=args.device)
x_row = torch.randn((1, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1)).to(pipe.device)
pipe.warmup(torch.cat([x_row] * MAX_BATCH, 0))
pipe.reset_clock()

xs = {t.name: x_row + i * 1e-3 for i, t in enumerate(mix.tenants)}
served, violated = 0, 0
timeline = []

with Gateway(pipe, mix, controller=ctrl, max_batch=MAX_BATCH,
             batch_window_s=0.01, inflight=2) as gw:
    for name in xs:                           # prime: one in flight each
        gw.submit(name, xs[name])
    win_qos, next_edge = [], WINDOW_S
    while pipe.clock() < T_END:
        for tenant, _req_id, _val in gw.poll(block=True):
            served += 1
            gw.submit(tenant, xs[tenant])     # closed loop
        win_qos.extend(gw.drain_qos())
        if pipe.clock() >= next_edge:
            lats = [r.latency_s for r in win_qos] or [0.0]
            vio = sum(r.violated for r in win_qos)
            violated += vio
            timeline.append((next_edge, len(win_qos),
                             float(np.percentile(lats, 99)), vio,
                             gw.inflight_window, splitter.policy,
                             float(np.mean([r.occupancy
                                            for r in win_qos] or [0.0]))))
            win_qos, next_edge = [], next_edge + WINDOW_S
    leftovers = gw.drain()
    served += sum(len(v) for v in leftovers.values())

print(f"\n{'t':>5} {'req/s':>6} {'p99':>8} {'viol':>5} {'win':>4} "
      f"{'policy':>11} {'occup':>6}")
for t, n, p99, vio, win, policy, occ in timeline:
    print(f"{t:4.0f}s {n / WINDOW_S:6.0f} {p99 * 1e3:6.1f}ms {vio:>5} "
          f"{win:>4} {policy:>11} {occ:6.2f}")

print(f"\nserved {served} requests from {len(mix.tenants)} tenants; "
      f"{violated} SLO violations (concentrated in the spike and the "
      f"migration dips)")
print("admission window excursions (t, window):")
print("  " + " -> ".join(f"({t:.2f}s, {w})" for t, w in gw.window_history))
obj = ctrl.fleet_objectives()
if obj is not None:
    print(f"fleet objectives at close: p99 {obj.p99_s * 1e3:.1f} ms vs "
          f"strictest SLO {obj.strictest_slo_s * 1e3:.0f} ms, "
          f"{obj.aggregate_ips:.0f} req/s, {obj.j_per_request:.2f} J/req "
          f"-> policy {obj.policy!r}")
print(f"fleet control decisions: {len(ctrl.fleet_history)}; "
      f"migrations: {len(pipe.migrations)}")
assert drain_violations() == []
pipe.close()
