"""One rank of the port's sharded train and serving steps, for the rank
tests (``tests/test_torch_sharded_train.py``,
``test_torch_sharded_families.py``, ``test_torch_sharded_serve.py``,
``test_torch_dryrun.py``).

    python tests/_torch_sharded_ranks.py CASES.json OUT.npz

started as every rank of a gloo group by ``launch.mesh.spawn_ranks``.
``CASES.json`` lists the cases, each {"case", "arch", "mesh": [data,
model], "compress", "weights": a reference npz (its ``params/...`` and
``batch/...``) or null for ``--seed 0`` weights and batch, "batch",
"seq", "accum": ``grad_accum``, "plain": also run the one-process
step}.  Every rank runs every
case's one train step (AdamW at lr 1e-3) on the case's ``(data,
model)`` mesh over the group; rank 0 writes the npz, keys joined by
``/``: ``<case>/metrics/...``, ``<case>/m/...`` and ``<case>/v/...`` (the
moments gathered, in the reference's layout), ``<case>/bytes/<leaf>``
(each rank's bytes of that reference leaf's first moment, in rank
order), ``<case>/kept`` (whether each rank's ``reference_state`` kept
the gathered tree) and, with "plain", ``<case>/plain/{metrics,m,v}/...``: the same
step in this process without a mesh.

A case with ``"kind": "serve"`` ({"case", "arch", "mesh", "weights",
"impl": ``attn_impl``, "cache", "decode", "plain"}) serves the
weights' batch (targets dropped) through ``make_prefill_step`` and
``decode`` greedy ``make_decode_step``s under the mesh: ``<case>/tokens``
(steps + 1, B), ``<case>/logits/<i>``, ``<case>/placements/<leaf>`` (the
prefill cache's, as text) and ``<case>/names/<leaf>`` (the placements of
``lm.cache_names``), and with "plain" ``<case>/plain/{tokens,logits}``:
the same serve in this process without a mesh.  A case with ``"kind":
"dryrun"`` ({"case", "arch", "mesh", "shape": [kind, seq, batch],
"accum"}) runs ``launch.dryrun.measure`` on real, zero-filled tensors:
``<case>/flops``, ``<case>/peak`` and ``<case>/coll/<kind>/{count,bytes}``
of rank 0; with "pcfg": [stages, microbatches, cuts] on the ``(pod,
data, model)`` mesh "mesh", its pipelined step, its collectives split
``<case>/pod/<kind>/<crossing|within>/{count,bytes}``.

The pod mesh's cases run on ``launch.mesh.pod_mesh`` ("mesh": [pods,
data, model]; a mesh of fewer ranks than the group's takes its first
ones, and the others sit the case out).  ``"kind": "pod-train"``
({"case", "arch", "depth", "cuts", "mesh", "weights": a reference npz
of ``_torch_pipeline_ref.py``'s train mode}) runs one pipelined train
step (2 microbatches) of the case's weights and batch:
``<case>/metrics/...`` and ``<case>/m/...``, the first moment gathered
to rank 0 in the reference's pipeline layout.  ``"kind": "pod-serve"``
({"case", "arch", "depth", "cuts", "mesh", "weights": its serve mode's
npz, and "from": the npz's case, if not "case"}) runs the pipelined
prefill (a cache of 18) and two greedy decode steps:
``<case>/<step>/tokens`` and ``<case>/<step>/cache/...`` (the
reference's layout, gathered to rank 0) for ``prefill``, ``decode0``
and ``decode1``, and ``<case>/placements/<leaf>`` of rank 0's stage
cache.  ``"kind": "cli-serve"`` ({"case", "argv"}) runs
``launch.serve.main(argv)`` in every rank: ``<case>/tokens`` of rank 0.
"""
import copy
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import join, make_host_mesh
from repro_torch.models import lm
from repro_torch.optim import CompressionConfig, OptConfig
from repro_torch.optim.adamw import reference_leaf
from repro_torch.runtime import steps
from repro_torch.sharding.api import local, use_mesh_context

LR = 1e-3


def put(out, prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(out, f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(tree)


def nested(z, prefix):
    tree: dict = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        *parents, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return tree


def setup(case):
    cfg = configs.reduced(case["arch"])
    if case["weights"]:
        with np.load(case["weights"]) as z:
            model = lm.from_reference(cfg, nested(z, "params"), "cpu")
            batch = {k: torch.from_numpy(np.array(v))
                     for k, v in nested(z, "batch").items()}
    else:
        model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = SyntheticLM(cfg, DataConfig(case["batch"], case["seq"], 0),
                            device="cpu").batch_at(0)
    return cfg, model, batch


def one_step(cfg, model, batch, comp, accum, mesh=None):
    with use_mesh_context(mesh):
        state = steps.train_state(model, comp)
        step = steps.make_train_step(cfg, OptConfig(lr=LR), comp, accum)
    return step(state, batch)


def run(case, out):
    cfg, model, batch = setup(case)
    comp = CompressionConfig(enabled=case["compress"])
    rank = dist.get_rank()
    c = case["case"]
    if case["plain"] and rank == 0:
        state, m = one_step(cfg, copy.deepcopy(model), batch, comp,
                            case["accum"])
        put(out, f"{c}/plain/metrics", {k: v.item() for k, v in m.items()})
        ref = steps.reference_state(state)
        put(out, f"{c}/plain/m", ref["opt"]["m"])
        put(out, f"{c}/plain/v", ref["opt"]["v"])
    mesh = make_host_mesh(1, *case["mesh"], "cpu")
    state, m = one_step(cfg, model, batch, comp, case["accum"], mesh)
    # every rank gathers, rank 0 alone keeps the tree
    ref = steps.reference_state(state, keep=rank == 0)
    mine: dict[str, int] = {}
    for n, t in state["opt"]["m"].items():
        leaf = reference_leaf(n)[0]
        mine[leaf] = mine.get(leaf, 0) + local(t).numel() * 4
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mine, ref is not None))
    if rank == 0:
        out[f"{c}/kept"] = np.array([k for _, k in every])
        every = [b for b, _ in every]
        put(out, f"{c}/metrics", {k: v.item() for k, v in m.items()})
        put(out, f"{c}/m", ref["opt"]["m"])
        put(out, f"{c}/v", ref["opt"]["v"])
        for leaf in mine:
            out[f"{c}/bytes/{leaf}"] = np.array([b[leaf] for b in every])


def served(cfg, model, inputs, clen, n, mesh=None):
    with use_mesh_context(mesh):
        prefill = steps.make_prefill_step(cfg, clen, with_logits=True)
        decode = steps.make_decode_step(cfg, with_logits=True)
    tok, cache, lg = prefill(model, inputs)
    first = cache
    toks, logits = [tok], [lg]
    for _ in range(n):
        tok, cache, lg = decode(model, tok, cache)
        toks.append(tok)
        logits.append(lg)
    return toks, logits, first


def serve(case, out):
    c = case["case"]
    cfg = configs.reduced(case["arch"]).replace(attn_impl=case["impl"])
    with np.load(case["weights"]) as z:
        model = lm.from_reference(cfg, nested(z, "params"), "cpu")
        inputs = {k: torch.from_numpy(np.array(v))
                  for k, v in nested(z, "batch").items() if k != "targets"}
    rank = dist.get_rank()
    if case["plain"] and rank == 0:
        toks, logits, _ = served(cfg, copy.deepcopy(model), inputs,
                                 case["cache"], case["decode"])
        out[f"{c}/plain/tokens"] = torch.cat(toks, 1).T.numpy()
        for i, lg in enumerate(logits):
            out[f"{c}/plain/logits/{i}"] = lg.numpy()
    mesh = make_host_mesh(1, *case["mesh"], "cpu")
    with use_mesh_context(mesh) as ctx:
        lm.shard_params(cfg, model, ctx)
    toks, logits, cache = served(cfg, model, inputs, case["cache"],
                                 case["decode"], mesh)
    if rank == 0:
        out[f"{c}/tokens"] = torch.cat(toks, 1).T.numpy()
        for i, lg in enumerate(logits):
            out[f"{c}/logits/{i}"] = lg.numpy()
        for k, t in cache.items():
            if k != "pos":
                out[f"{c}/placements/{k}"] = np.array(str(t.placements))
                with use_mesh_context(mesh) as ctx:
                    out[f"{c}/names/{k}"] = np.array(str(ctx.placements(
                        lm.cache_names(cfg, k), tuple(t.shape))))


def dryrun(case, out):
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.runtime.pipeline import PipelineConfig
    c = case["case"]
    kind, seq, batch = case["shape"]
    cfg = configs.reduced(case["arch"])
    pcfg = None
    if case.get("pcfg"):
        n, mb, cuts = case["pcfg"]
        pcfg = PipelineConfig(n, mb, tuple(cuts))
        mesh = pod_mesh(case["mesh"])
    else:
        mesh = make_host_mesh(1, *case["mesh"], "cpu")
    got = D.measure(cfg, ShapeSpec(c, seq, batch, kind), mesh, fake=False,
                    grad_accum=case["accum"], pcfg=pcfg)
    if dist.get_rank() == 0:
        out[f"{c}/flops"] = np.array(got["flops"])
        out[f"{c}/peak"] = np.array(got["memory"]["peak"])
        for k, d in got["collectives"].by_kind().items():
            out[f"{c}/coll/{k}/count"] = np.array(d["count"])
            out[f"{c}/coll/{k}/bytes"] = np.array(d["bytes"])
        for k, d in got["collectives"].by_kind_and_pod().items():
            out[f"{c}/pod/{k}/count"] = np.array(d["count"])
            out[f"{c}/pod/{k}/bytes"] = np.array(d["bytes"])


MESHES: dict = {}


def pod_mesh(shape):
    """The group's ``(pod, data, model)`` mesh of ``shape``, made once; on
    fewer ranks than the group's, its first ones (None on the others)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import mesh as M
    shape = tuple(shape)
    if shape not in MESHES:
        n = int(np.prod(shape))
        if n == dist.get_world_size():
            MESHES[shape] = M.pod_mesh(*shape, "cpu")
        else:
            mesh = DeviceMesh("cpu", torch.arange(n).view(*shape),
                              mesh_dim_names=("pod", "data", "model"))
            MESHES[shape] = mesh if mesh.get_coordinate() is not None \
                else None
    return MESHES[shape]


def pod_case(case, key):
    from repro_torch.runtime.pipeline import PipelineConfig
    cfg = configs.reduced(case["arch"])
    if case["depth"] is not None:
        cfg = cfg.replace(n_layers=case["depth"])
    mb = 2 if case["kind"] == "pod-train" else 1
    pcfg = PipelineConfig.even(cfg.n_layers, 2, mb) if case["cuts"] is None \
        else PipelineConfig(2, mb, tuple(case["cuts"]))
    src = case.get("from", case["case"])
    with np.load(case["weights"]) as z:
        model = lm.from_reference(cfg, nested(z, f"{src}/params"), "cpu")
        data = {k: torch.from_numpy(np.array(v)) for k, v in
                nested(z, f"{src}/{key}").items()}
    return cfg, pcfg, model, data


def pod_train(case, out):
    from repro_torch.runtime import pipeline as PL
    mesh = pod_mesh(case["mesh"])
    if mesh is None:
        return
    c = case["case"]
    cfg, pcfg, model, batch = pod_case(case, "batch")
    PL.place_stages(cfg, model, pcfg, mesh)
    with use_mesh_context(PL.stage_context(mesh)):
        state = steps.train_state(model)
    state, m = PL.make_pipeline_train_step(cfg, pcfg, OptConfig(lr=LR),
                                           mesh)(state, batch)
    ref = steps.reference_state(state, pcfg, keep=dist.get_rank() == 0)
    if ref is not None:
        put(out, f"{c}/metrics", {k: v.item() for k, v in m.items()})
        put(out, f"{c}/m", ref["opt"]["m"])


def pod_serve(case, out):
    from repro_torch.runtime import pipeline as PL
    mesh = pod_mesh(case["mesh"])
    if mesh is None:
        return
    c = case["case"]
    cfg, pcfg, model, inputs = pod_case(case, "inputs")
    PL.place_stages(cfg, model, pcfg, mesh)
    prefill = PL.make_pipeline_prefill_step(cfg, pcfg, mesh, cache_len=18)
    decode = PL.make_pipeline_decode_step(cfg, pcfg, mesh)
    lead = dist.get_rank() == 0
    tok, cache = prefill(model, inputs)
    if lead:
        for k, t in cache["stage"].items():
            out[f"{c}/placements/{k}"] = np.array(str(t.placements))
    for step in ("prefill", "decode0", "decode1"):
        if step != "prefill":
            tok, cache = decode(model, tok, cache)
        got = PL.reference_cache(cfg, pcfg, cache, mesh, keep=lead)
        if lead:
            out[f"{c}/{step}/tokens"] = tok.numpy()
            put(out, f"{c}/{step}/cache", {k: v for k, v in got.items()})


def cli_serve(case, out):
    from repro_torch.launch import serve as SV
    res = SV.main(case["argv"])
    if dist.get_rank() == 0:
        out[f"{case['case']}/tokens"] = res["tokens"].numpy()


def main(cases_path, out_path):
    torch.set_num_threads(1)
    with open(cases_path) as f:
        cases = json.load(f)
    out: dict = {}
    join("cpu")
    for case in cases:
        {"serve": serve, "dryrun": dryrun, "pod-train": pod_train,
         "pod-serve": pod_serve, "cli-serve": cli_serve}.get(
            case.get("kind"), run)(case, out)
    if dist.get_rank() == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
