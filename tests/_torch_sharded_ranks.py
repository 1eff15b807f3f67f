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
of rank 0.
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
    c = case["case"]
    kind, seq, batch = case["shape"]
    cfg = configs.reduced(case["arch"])
    mesh = make_host_mesh(1, *case["mesh"], "cpu")
    got = D.measure(cfg, ShapeSpec(c, seq, batch, kind), mesh, fake=False,
                    grad_accum=case["accum"])
    if dist.get_rank() == 0:
        out[f"{c}/flops"] = np.array(got["flops"])
        out[f"{c}/peak"] = np.array(got["memory"]["peak"])
        for k, d in got["collectives"].by_kind().items():
            out[f"{c}/coll/{k}/count"] = np.array(d["count"])
            out[f"{c}/coll/{k}/bytes"] = np.array(d["bytes"])


def main(cases_path, out_path):
    torch.set_num_threads(1)
    with open(cases_path) as f:
        cases = json.load(f)
    out: dict = {}
    join("cpu")
    for case in cases:
        {"serve": serve, "dryrun": dryrun}.get(case.get("kind"), run)(
            case, out)
    if dist.get_rank() == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
