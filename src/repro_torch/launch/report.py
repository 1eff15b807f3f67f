"""Generate EXPERIMENTS.md sections from dry-run manifests (a copy of
``src/repro/launch/report.py``: the manifests of either package's
``launch.dryrun`` keep the same keys, so it reads both).

    PYTHONPATH=src python -m repro_torch.launch.report \
        --runs runs/dryrun --baseline runs/dryrun_baseline_v0
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(d: Path) -> dict:
    recs = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_s(x: float) -> str:
    return f"{x*1e3:.1f}ms" if x < 10 else f"{x:.1f}s"


def dryrun_table(recs: dict) -> str:
    lines = ["| arch | shape | mesh | status | compile | peak GB/dev | "
             "collectives (per scan iter) |",
             "|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if r["status"] == "skipped":
            lines.append(f"| {a} | {s} | {m} | SKIP | — | — | "
                         f"{r.get('reason','')[:60]} |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {a} | {s} | {m} | **FAIL** | — | — | "
                         f"{r.get('error','')[:60]} |")
            continue
        coll = ", ".join(f"{k}×{v['count']}"
                         for k, v in sorted(r["collectives"].items()))
        lines.append(
            f"| {a} | {s} | {m} | ok | {r['compile_s']}s | "
            f"{r['memory']['peak_mb']/1000:.1f} | {coll or '—'} |")
    return "\n".join(lines)


def roofline_table(recs: dict) -> str:
    lines = ["| arch | shape | compute | memory | collective | dominant | "
             "bound | MFU-bound | useful |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if m != "16x16" or r["status"] != "ok":
            continue
        rl = r["roofline"]
        lines.append(
            f"| {a} | {s} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
            f"**{rl['dominant']}** | {fmt_s(rl['step_bound_s'])} | "
            f"{rl['mfu_bound']*100:.0f}% | {rl['useful_ratio']:.2f} |")
    return "\n".join(lines)


def perf_compare(base: dict, cur: dict) -> str:
    lines = ["| cell | peak GB/dev before → after | bound before → after |",
             "|---|---|---|"]
    for key in sorted(cur):
        b, c = base.get(key), cur[key]
        if not b or b.get("status") != "ok" or c.get("status") != "ok":
            continue
        pb = b["memory"]["peak_mb"] / 1000
        pc = c["memory"]["peak_mb"] / 1000
        if abs(pb - pc) / max(pb, 0.01) < 0.05:
            continue
        lines.append(
            f"| {key[0]} {key[1]} {key[2]} | {pb:.1f} → {pc:.1f} "
            f"({pc/pb-1:+.0%}) | {fmt_s(b['roofline']['step_bound_s'])} → "
            f"{fmt_s(c['roofline']['step_bound_s'])} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="runs/dryrun")
    ap.add_argument("--baseline", default="")
    args = ap.parse_args()
    cur = load(Path(args.runs))
    n_ok = sum(r["status"] == "ok" for r in cur.values())
    n_skip = sum(r["status"] == "skipped" for r in cur.values())
    n_fail = len(cur) - n_ok - n_skip
    print(f"### Cells: {len(cur)} total — {n_ok} ok / {n_skip} skipped / "
          f"{n_fail} failed\n")
    print("## §Dry-run\n")
    print(dryrun_table(cur))
    print("\n## §Roofline (single-pod 16×16, per device)\n")
    print(roofline_table(cur))
    if args.baseline:
        base = load(Path(args.baseline))
        print("\n## §Perf: baseline → optimized (cells that moved ≥5%)\n")
        print(perf_compare(base, cur))


if __name__ == "__main__":
    main()
