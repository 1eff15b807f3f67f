#!/usr/bin/env python
"""How far the closed adaptive loop over measured socket hops sits from
its migration boundary, on the CPU, for either package.

The loop is ``tests/test_torch_adaptive.py``'s (and its twin
``tests/test_transport.py``'s): MobileNetV2 at 32x32, batch 2,
``pi_pi_gpu`` with both hops at ``DURESS`` over ``socket``, a check every
2 of 10 batches, ``migration_cost_s`` 0.01, ``alpha`` 0.8.  Three parts,
each printed as it ends:

- ``hop``: a socket ``EdgePipeline`` at the loop's first cuts (8, 9)
  runs ``--batches`` lone batches; each hop's receiver-measured elapsed
  (the sender's send stamp to the decoded tensor), median, p10 and p90.
- ``threshold``: the splitter the loop builds, stepped with estimates
  whose RTT is one of the loop's checks' and whose bandwidth is what a
  2 KiB transfer of the given elapsed attributes under that RTT
  (``attribute_bandwidth``; at the larger RTTs its floor, 2048 / (0.05
  x elapsed)); the largest elapsed at which a check migrates.
- ``loop``: the loop itself ``--runs`` times, with ``--spinners``
  busy processes of this script started first and stopped at the end;
  how many runs migrated.

One package a process: ``--package repro_torch`` (the port, torch on
the CPU, its own seeded weights) or ``--package repro`` (the JAX
reference; weights from ``PRNGKey(0)``).  The weights do not enter the
cuts or the timing.

    PYTHONPATH=src python tools/adaptive_margin.py --package repro_torch \\
        [--parts hop threshold loop] [--batches 300] [--runs 10] \\
        [--spinners 24]
"""
from __future__ import annotations

import argparse
import importlib
import multiprocessing as mp
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CUTS, BATCH, HW = (8, 9), 2, 32
LOOP = dict(policy="throughput", check_every=2, migration_cost_s=0.01,
            alpha=0.8)
N_BATCHES = 10
RTTS_MS = (40.0, 8.3, 2.0, 0.7)      # the RTT estimate at checks 1-4
ELAPSED_MS = tuple(x / 10 for x in range(2, 41))


def spin() -> None:
    while True:
        pass


class Package:
    """The pieces of one package the three parts use."""

    def __init__(self, name: str):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.scenarios = mod("core.scenarios")
        self.devices = mod("core.devices")
        self.autosplit = mod("core.autosplit")
        self.runtime = mod("runtime")
        zoo = mod("models.cnn.zoo")
        self.torch = name == "repro_torch"
        if self.torch:
            import torch
            torch.set_num_threads(1)
            self.model = zoo.get("mobilenetv2").init(
                torch.Generator().manual_seed(0), device="cpu")
            self.params = None
            self.x = torch.randn(BATCH, HW, HW, 3,
                                 generator=torch.Generator().manual_seed(1))
        else:
            import jax
            import numpy as np
            self.model = zoo.get("mobilenetv2")
            self.params = self.model.init(jax.random.PRNGKey(0))
            self.x = np.random.default_rng(1).standard_normal(
                (BATCH, HW, HW, 3)).astype(np.float32)

    def duress(self):
        d = self.devices.DURESS
        return (self.scenarios.get("pi_pi_gpu").with_link(0, d)
                .with_link(1, d).with_transport("socket"))

    def pipeline(self, scen):
        if self.torch:
            return self.runtime.EdgePipeline(self.model, CUTS, scen,
                                             device="cpu")
        return self.runtime.EdgePipeline(self.model, self.params, CUTS, scen)

    def adaptive(self, scen):
        graph = self.model.block_graph(input_hw=HW)
        if self.torch:
            return self.runtime.AdaptiveRuntime(
                self.model, scen, graph=graph, batch=BATCH, device="cpu",
                **LOOP)
        return self.runtime.AdaptiveRuntime(
            self.model, self.params, scen, graph=graph, batch=BATCH, **LOOP)


def hop(pkg: Package, batches: int) -> None:
    scen = pkg.scenarios.get("pi_pi_gpu").with_transport("socket")
    with pkg.pipeline(scen) as pipe:
        pipe.warmup(pkg.x)
        for _ in range(batches):
            pipe.run_one(pkg.x)
        pipe._engine.sync()
        for i, net in enumerate(pipe.nets):
            recs = [r for r in net.drain_observations() if r.nbytes > 0]
            ms = sorted(r.elapsed_s * 1e3 for r in recs[10:])
            q = statistics.quantiles(ms, n=10)
            print(f"{pkg.name} hop {i} ({recs[0].nbytes} B, cuts {CUTS}, "
                  f"{len(ms)} batches): median {statistics.median(ms):.3f} "
                  f"p10 {q[0]:.3f} p90 {q[-1]:.3f} ms", flush=True)


def threshold(pkg: Package) -> None:
    A, D = pkg.autosplit, pkg.devices
    scen = pkg.duress()
    graph = pkg.model.block_graph(input_hw=HW)
    for rtt_ms in RTTS_MS:
        last = None
        for el_ms in ELAPSED_MS:
            sp = A.AdaptiveSplitter(graph, scen, batch=BATCH,
                                    policy=LOOP["policy"],
                                    migration_cost_s=LOOP["migration_cost_s"],
                                    include_io=False)
            sp.current = sp.solve()
            bw = D.attribute_bandwidth(2048, el_ms / 1e3, rtt_ms / 1e3,
                                       D.DURESS.per_msg_overhead_s)
            est = A.LinkEstimator(
                rtt_s=rtt_ms / 1e3, bw_bytes_per_s=bw,
                per_msg_overhead_s=D.DURESS.per_msg_overhead_s)
            if sp.step([est, est])[1]:
                last = el_ms
        span = f"{ELAPSED_MS[0]}-{ELAPSED_MS[-1]} ms"
        print(f"{pkg.name} threshold: RTT estimate {rtt_ms} ms: "
              + (f"a check migrates while a 2 KiB transfer takes at most "
                 f"{last} ms" if last is not None else
                 f"no elapsed in {span} migrates"), flush=True)


def loop(pkg: Package, runs: int) -> None:
    migrated = 0
    for i in range(runs):
        t = time.perf_counter()
        with pkg.adaptive(pkg.duress()) as rt:
            recs = rt.run(lambda: pkg.x, n_batches=N_BATCHES)
            ok = any(r.migrated for r in recs)
        migrated += ok
        print(f"{pkg.name} loop run {i}: migrated {ok}, cut history "
              f"{' -> '.join(map(str, rt.cut_history))} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"{pkg.name} loop: migrated in {migrated} of {runs} runs",
          flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("repro_torch", "repro"),
                    required=True)
    ap.add_argument("--parts", nargs="+", default=["hop", "threshold",
                                                   "loop"],
                    choices=("hop", "threshold", "loop"))
    ap.add_argument("--batches", type=int, default=300)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--spinners", type=int, default=0)
    args = ap.parse_args(argv)
    if args.package == "repro":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pkg = Package(args.package)
    ctx = mp.get_context("spawn")
    spinners = [ctx.Process(target=spin, daemon=True)
                for _ in range(args.spinners)]
    for p in spinners:
        p.start()
    try:
        if "hop" in args.parts:
            hop(pkg, args.batches)
        if "threshold" in args.parts:
            threshold(pkg)
        if "loop" in args.parts:
            loop(pkg, args.runs)
    finally:
        for p in spinners:
            p.terminate()
            p.join()
    print(f"{os.cpu_count()} CPUs, {args.spinners} spinning processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
