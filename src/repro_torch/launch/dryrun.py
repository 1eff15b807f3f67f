"""Dry run: every (arch × shape × mesh) cell's step, run once without
weights (counterpart of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices
and never runs it.  PyTorch runs eagerly and compiles nothing, so here
each cell runs the port's own step once, as rank 0 of a fake process
group (``torch.testing``'s ``FakeStore`` backend: every collective and
point-to-point op returns at once) of 256 ranks, or 512 for the
multi-pod mesh, inside ``FakeTensorMode``, where no tensor holds
storage.  DTensor takes its real decisions on the real
``DeviceMesh`` and issues its real collectives; only their data is
absent.  For each cell this harness

  1. builds the production mesh (16 x 16 ``(data, model)``, or the
     multi-pod 2 x 16 x 16 ``(pod, data, model)``),
  2. builds the state and inputs from ``launch.specs.input_specs``
     (``specs.materialize``: each rank's shards only, no storage; on
     the multi-pod mesh rank 0's, pod 0's stage),
  3. runs the step once (``make_train_step`` with ``grad_accum=4``, or
     the prefill or decode step; on the multi-pod mesh the pipelined
     steps over ``PipelineConfig.even(n_layers, 2, mb)``, 8 microbatches
     for training and 1 for serving, the moe family on its GShard
     route, as the reference's ``_build_step``) under ``MemTracker``
     (memory, per rank), ``FlopCounterMode`` (FLOPs, per rank) and the
     collective recorder (``hlo_analysis.CollectiveRecorder``, which
     marks each collective crossing pods or not), a CPU mesh moving a
     ``Shard(i)`` to a ``Shard(j)`` by the card's all-to-all
     (``card_redistribution``),
  4. records the analytic cost model's roofline terms
     (``launch/analytic.py:cell_cost`` with ``roofline_from``, the H100's
     peaks), as the reference does (``dryrun.py:280-321``),
  5. writes a JSON manifest per cell (resumable), with the reference's
     keys, so that ``launch.report`` reads either package's manifests.

Where the reference times lowering and compiling, ``lower_s`` times
building the fake state and inputs and ``compile_s`` the fake step.
``memory`` (MB, per rank): ``args_mb`` the step's inputs (the batch or
token whole, as the port's steps take them), ``output_mb`` its outputs
(a train step's updated state among them), ``peak_mb`` the most that
``MemTracker`` holds after any op of the step (the inputs included) and
``temp_mb`` the peak less the inputs.  In place of ``xla_raw``,
``counted`` holds what the run counted: its FLOPs and its collectives'
wire bytes, per rank; ``collectives_by_pod`` splits each kind's count
and bytes into the ops whose group crosses a pod and the others.
A decode cell attends over the whole cache (``pos`` = seq - 1).  The
serving cells take the registered config's route (``attn_impl``, the
plain one), as the reference's do.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh single [--force] \\
      [--out runs/dryrun]

Used as a library (``run_cell``, ``fake_group``), the dry run leaves no
process group behind.
"""
import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

GRAD_ACCUM = 4       # the reference's: 4x smaller activation working set
TRAIN_ATTN_CHUNK = 1024   # the reference's flash block size for train
WORLD = 256          # the single-pod mesh's ranks
MULTI_WORLD = 512    # the multi-pod mesh's
CELL_TIMEOUT_S = 3600     # a cell of a sweep, in its own process


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0,
    destroyed on the way out (also on an error)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes a fake process group of its "
                           "own: run it outside a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def card_redistribution(mesh):
    """While open, DTensor moves a ``Shard(i)`` to a ``Shard(j)`` on one
    dim of a CPU ``mesh`` as it does on the card's: one all-to-all
    (``_dtensor.shard_dim_alltoall``).  On a CPU mesh torch's own rule
    is an all-gather of the whole dim and a local chunk, for gloo's
    sake; gloo runs the all-to-all too, to the same values.  So the
    collectives a CPU sweep counts are those a CUDA mesh issues (the
    hybrid's train step moves gradients of its Mamba-2 activations so).
    A no-op for another mesh or none."""
    from torch.distributed.tensor import placement_types
    if mesh is None or mesh.device_type != "cpu":
        yield
        return
    import torch
    import torch.distributed._functional_collectives as funcol
    original = placement_types.shard_dim_alltoall

    def all_to_all(x, gather_dim, shard_dim, on_mesh, mesh_dim):
        group = funcol._resolve_group((on_mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, funcol._group_or_group_name(group))
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


def _build_step(cfg, shape, grad_accum: int, pcfg=None, mesh=None):
    from ..optim import OptConfig
    from ..runtime import pipeline as PL
    from ..runtime import steps as S
    if pcfg is not None:
        if shape.kind == "train":
            return PL.make_pipeline_train_step(cfg, pcfg, OptConfig(), mesh)
        if shape.kind == "prefill":
            return PL.make_pipeline_prefill_step(cfg, pcfg, mesh)
        return PL.make_pipeline_decode_step(cfg, pcfg, mesh)
    if shape.kind == "train":
        return S.make_train_step(cfg, OptConfig(), grad_accum=grad_accum)
    if shape.kind == "prefill":
        return S.make_prefill_step(cfg)
    return S.make_decode_step(cfg)


def cell_args(cfg, shape, ctx, mesh, device, zeros: bool = False,
              pcfg=None) -> tuple:
    """The step's arguments for ``shape`` from ``specs.input_specs``: the
    state or model as DTensors of this rank's shards (plain tensors
    without a mesh; with ``pcfg``, this rank's stage on its pod's
    sub-mesh), the batch or token whole and the cache's ``pos`` the int
    seq - 1.  Uninitialised (no storage in ``FakeTensorMode``), or
    zero-filled with ``zeros``."""
    from ..models import lm
    from . import specs as SP
    from .mesh import stage_mesh
    cell = SP.materialize(SP.input_specs(cfg, shape, ctx, pcfg),
                          mesh if pcfg is None else stage_mesh(mesh), device,
                          zeros=zeros, pos=shape.seq - 1,
                          whole=("batch", "inputs", "token", "count",
                                 "step"))

    def built(params):
        model = lm.LM(cfg, params)
        if pcfg is not None:
            model.pod_mesh = mesh
        return model
    if shape.kind == "train":
        st = cell["state"]
        model = built(st["params"]).requires_grad_(True)
        return ({"model": model, "opt": st["opt"], "step": st["step"]},
                cell["batch"])
    model = built(cell["params"])
    if shape.kind == "prefill":
        return model, cell["inputs"]
    return model, cell["token"], cell["cache"]


def _tensors(tree):
    import torch
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def local_bytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree`` (a module's parameters
    included), a DTensor's local shard's on this rank."""
    from ..sharding.api import local
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) in seen:
            continue
        seen.add(id(t))
        t = local(t)
        total += t.numel() * t.element_size()
    return total


def _peak_mode(mt):
    """A dispatch mode whose ``bytes`` is the largest total that ``mt``
    (a ``MemTracker``) holds after any op of the step.  The tracker's
    own peak would also count, inside ``FakeTensorMode``, the tensors
    that DTensor's sharding propagation makes under that same mode,
    which a real run never holds; after each op the two runs hold the
    same."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Peak(TorchDispatchMode):
        bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            # the tracker's running totals, read without the copy that
            # get_tracker_snapshot makes
            snap = getattr(mt, "_curr_mem_snap", None) or \
                mt.get_tracker_snapshot("current")
            self.bytes = max(self.bytes,
                             sum(d["Total"] for d in snap.values()))
            return out
    return Peak()


def measure(cfg, shape, mesh, *, device="cpu", fake: bool = True,
            grad_accum: int = GRAD_ACCUM, pcfg=None) -> dict:
    """One step of the cell ``shape`` (a ``specs.ShapeSpec``) on ``mesh``
    (None: one device; with ``pcfg`` the pipelined step on a ``(pod,
    data, model)`` mesh), as this rank runs it: inside ``FakeTensorMode``
    with ``fake`` (nothing allocated), else on zero-filled tensors →
    {"lower_s", "compile_s", "memory" (bytes), "flops", "collectives" (a
    ``CollectiveSummary``)}.  Run on a real group and on a fake one of
    the same size, rank 0's numbers are the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from ..sharding.api import MeshContext, use_mesh_context
    from .hlo_analysis import CollectiveRecorder
    from .mesh import stage_mesh
    ctx = None if mesh is None else MeshContext(mesh)
    if pcfg is not None:
        stage_mesh(mesh)              # sliced here, outside the counting
    t0 = time.perf_counter()
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    with mode, use_mesh_context(mesh if pcfg is None else None):
        step = _build_step(cfg, shape, grad_accum, pcfg, mesh)
        args = cell_args(cfg, shape, ctx, mesh, device, zeros=not fake,
                         pcfg=pcfg)
        lower_s = time.perf_counter() - t0
        arg_bytes = local_bytes(args)
        mt = MemTracker()
        mt.track_external(*(m for m in _tensors(args)))
        rec = CollectiveRecorder(_pod_size(mesh))
        t1 = time.perf_counter()
        peak = _peak_mode(mt)
        with mt, peak, FlopCounterMode(display=False) as fc, rec, \
                card_redistribution(mesh):
            out = step(*args)
        compile_s = time.perf_counter() - t1
        peak = max(peak.bytes, arg_bytes)
        out_bytes = local_bytes(out)
    return {"lower_s": lower_s, "compile_s": compile_s,
            "memory": {"args": arg_bytes, "output": out_bytes,
                       "temp": peak - arg_bytes, "peak": peak},
            "flops": fc.get_total_flops(), "collectives": rec.summary}


def _pod_size(mesh) -> int | None:
    """The ranks of one pod of a ``(pod, data, model)`` mesh (None for
    another mesh): a collective's group crosses pods when its ranks lie
    in more than one such block."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh.size() // mesh.size(0) if "pod" in names else None


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 8, donate: bool = True) -> dict:
    """The cell's record (the reference's keys; ``donate`` is taken for
    its signature: an eager step has nothing to donate).  The multi-pod
    cell runs the pipelined step of pod 0's rank 0, ``microbatches`` for
    training."""
    from .. import configs
    from ..runtime.pipeline import PipelineConfig
    from . import specs as SP
    from .analytic import cell_cost
    from .mesh import make_production_mesh
    from .roofline import model_flops, roofline_from

    cfg = configs.get(arch)
    shape = SP.SHAPES[shape_name]
    if shape.kind == "train":
        cfg = cfg.replace(attn_chunk=TRAIN_ATTN_CHUNK)
    if multi_pod and cfg.family == "moe":
        cfg = cfg.replace(moe_impl="gshard")      # as the reference's cell
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "family": cfg.family, "kind": shape.kind}

    ok, why = SP.cell_supported(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    t0 = time.time()
    try:
        pcfg = PipelineConfig.even(
            cfg.n_layers, 2, microbatches if shape.kind == "train" else 1) \
            if multi_pod else None
        with fake_group(MULTI_WORLD if multi_pod else WORLD):
            mesh = make_production_mesh(multi_pod)
            n_chips = mesh.size()
            got = measure(cfg, shape, mesh, pcfg=pcfg)
        coll = got["collectives"]
        axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        cost = cell_cost(cfg, shape, n_chips=n_chips,
                         dp=axes.get("data", 1), tp=axes.get("model", 1),
                         multi_pod=multi_pod, pcfg=pcfg)
        mflops = model_flops(cfg, shape)
        rl = roofline_from(cost.flops_total / n_chips,
                           cost.hbm_bytes_per_dev,
                           cost.wire_ici_per_dev, cost.wire_dcn_per_dev,
                           mflops, n_chips)
        mem = got["memory"]
        rec.update(
            status="ok",
            lower_s=round(got["lower_s"], 1),
            compile_s=round(got["compile_s"], 1),
            n_chips=n_chips,
            flops_per_dev=cost.flops_total / n_chips,
            bytes_per_dev=cost.hbm_bytes_per_dev,
            memory={"args_mb": mem["args"] / 1e6,
                    "output_mb": mem["output"] / 1e6,
                    "temp_mb": mem["temp"] / 1e6,
                    "peak_mb": mem["peak"] / 1e6},
            collectives=coll.by_kind(),
            collectives_by_pod=coll.by_kind_and_pod(),
            wire_ici_per_dev=cost.wire_ici_per_dev,
            wire_dcn_per_dev=cost.wire_dcn_per_dev,
            counted={"flops_per_dev": float(got["flops"]),
                     "wire_ici_per_dev": coll.wire_bytes_ici,
                     "wire_dcn_per_dev": coll.wire_bytes_dcn,
                     "note": "rank 0 of a fake group in FakeTensorMode"},
            roofline={
                "compute_s": rl.compute_s, "memory_s": rl.memory_s,
                "collective_s": rl.collective_s, "dominant": rl.dominant,
                "step_bound_s": rl.step_time_s,
                "model_flops_total": mflops,
                "useful_ratio": rl.useful_ratio,
                "mfu_bound": rl.mfu_bound,
            },
        )
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main() -> int:
    from .. import configs
    from . import specs as SP

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(configs.ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SP.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = list(configs.ARCH_NAMES) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SP.SHAPES) if (args.all or not args.shape) \
        else [args.shape]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    single_cell = len(cells) == 1
    failures = 0
    for arch, shape, multi in cells:
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        path = out / f"{tag}.json"
        if path.exists() and not args.force:
            rec = json.loads(path.read_text())
            print(f"[cached] {tag}: {rec['status']}")
            failures += rec["status"] == "failed"
            continue
        if single_cell:
            rec = run_cell(arch, shape, multi, args.microbatches)
            path.write_text(json.dumps(rec, indent=1))
        else:
            # subprocess isolation: a hard crash in one cell must not
            # kill the sweep
            import subprocess
            import sys
            t0 = time.time()
            try:
                cp = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh",
                     "multi" if multi else "single", "--out", str(out),
                     "--microbatches", str(args.microbatches)]
                    + (["--force"] if args.force else []),
                    capture_output=True, text=True, timeout=CELL_TIMEOUT_S)
                err = cp.stderr.strip()
                err = "hard crash: " + err.splitlines()[-1][:200] if err \
                    else "hard crash"
            except subprocess.TimeoutExpired:
                # a straggler is a failed cell, not the end of the sweep
                err = f"timed out after {CELL_TIMEOUT_S} s"
            if not path.exists():
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if multi else "16x16",
                       "status": "failed", "error": err,
                       "wall_s": round(time.time() - t0, 1)}
                path.write_text(json.dumps(rec, indent=1))
            else:
                rec = json.loads(path.read_text())
        line = f"[{rec['status']:7s}] {tag} ({rec.get('wall_s', 0)}s)"
        if rec["status"] == "ok":
            r = rec["roofline"]
            line += (f" dominant={r['dominant']}"
                     f" bound={r['step_bound_s']*1e3:.1f}ms"
                     f" peak={rec['memory']['peak_mb']:.0f}MB/dev")
        elif rec["status"] == "failed":
            failures += 1
            line += " " + rec.get("error", "")[:160]
        print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
