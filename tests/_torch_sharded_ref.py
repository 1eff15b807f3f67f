"""The JAX reference's sharded train steps and serving steps, run for
the port's rank tests (``tests/test_torch_sharded_train.py``,
``test_torch_sharded_families.py``, ``test_torch_sharded_serve.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_torch_sharded_ref.py CASES.json OUT.npz

``CASES.json`` lists the cases as the port's ranks take them
(``_torch_sharded_ranks.py``): {"case", "arch", "mesh": [data, model],
"compress", "accum": ``grad_accum``, "weights": an npz that
``weights`` wrote, its ``params/...`` and ``batch/...``}.  Each case is
one ``make_train_step`` of the arch's reduced fp32 config under
``use_mesh_context``, on a mesh made with ``AxisType.Auto`` axes (jax
0.9's default ``Explicit`` axes trip the reference's ``shard()``:
ROADMAP queue 3).  A mesh of fewer than 4 devices takes the first
ones.  Nothing of the reference changes here.

``MESHES`` are the cases of reduced qwen3-1.7b (4 heads, 2 kv heads,
d_model 64, 2 layers) at batch 4, seq 24: the (1, 3) mesh shards q's
sequence, ``seq_sp``, since 4 heads do not divide by 3.

``OUT.npz``, keys joined by ``/``: for each case ``<case>/metrics/...``
and ``<case>/m/...`` (the first AdamW moment, from which the test
recovers the gradients).

A case with ``"kind": "serve"`` ({"case", "arch", "mesh", "weights",
"cache": its length, "decode": the steps}) runs the reference's
``make_prefill_step`` on the weights' batch (its targets dropped) and
``decode`` ``make_decode_step``s after it, each jitted under the mesh,
and the same steps' logits (``lm.forward_prefill`` /
``forward_decode``): ``<case>/tokens`` (steps + 1, B),
``<case>/logits/<i>``, and of the prefill's cache each leaf's
PartitionSpec as it came out (``<case>/out_spec/<leaf>``) and as
``launch/specs.py:cache_specs`` states it (``<case>/spec/<leaf>``),
JSON text, one entry a tensor dim.
"""
import json
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as configs
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import lm
from repro.models.common import InitBuilder
from repro.optim import CompressionConfig, OptConfig, init_error_state
from repro.optim import init_opt_state
from repro.runtime.steps import make_train_step
from repro.sharding.api import use_mesh_context

ARCH, BATCH, SEQ, LR = "qwen3-1.7b", 4, 24, 1e-3
# case → (mesh shape, compression)
MESHES = {"2x2": ((2, 2), False), "4x1": ((4, 1), False),
          "1x4": ((1, 4), False), "1x3": ((1, 3), False),
          "2x1-compressed": ((2, 1), True)}


class StableInit(InitBuilder):
    """The reference's ``InitBuilder`` with each leaf's key folded with a
    CRC of its path, in place of ``hash(path)``, which Python salts per
    process: the same weights on every run."""

    def leaf(self, path, shape, axes, **kw):
        key = jax.random.fold_in(self.key,
                                 zlib.crc32(path.encode()) & 0x7FFFFFFF)
        # InitBuilder.leaf folds its key with hash(path): the empty
        # path's hash is 0 in every process
        return InitBuilder(key, self.dtype).leaf("", shape, axes, **kw)


def put(out, prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(out, f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(tree)


def weights(path, arch=ARCH, batch=BATCH, seq=SEQ):
    """``arch``'s reduced fp32 weights, from ``PRNGKey(0)``, and its
    batch into ``path``."""
    cfg = configs.reduced(arch)
    out: dict = {}
    put(out, "params", lm.build_params(cfg, StableInit(
        jax.random.PRNGKey(0), jnp.float32)))
    put(out, "batch", SyntheticLM(cfg, DataConfig(batch=batch,
                                                  seq=seq)).batch_at(0))
    np.savez(path, **out)


def nested(z, prefix):
    tree: dict = {}
    for key in z.files:
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(z[key])
    return tree


def _spec_text(spec, ndim):
    """A PartitionSpec as JSON text, padded to ``ndim`` entries."""
    entries = [None if e is None else e if isinstance(e, str) else list(e)
               for e in tuple(spec)]
    return json.dumps(entries + [None] * (ndim - len(entries)))


def serve(c, out):
    from repro.launch.specs import cache_specs
    from repro.runtime.steps import make_decode_step, make_prefill_step
    cfg = configs.reduced(c["arch"])
    with np.load(c["weights"]) as z:
        params, batch = nested(z, "params"), nested(z, "batch")
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    n = c["mesh"][0] * c["mesh"][1]
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    clen = c["cache"]
    with use_mesh_context(mesh) as ctx:
        prefill = jax.jit(make_prefill_step(cfg, clen))
        decode = jax.jit(make_decode_step(cfg))
        first = jax.jit(lambda p, i: lm.forward_prefill(cfg, p, i, clen)[0])
        step = jax.jit(lambda p, t, k: lm.forward_decode(cfg, p, t, k)[0])
        tok, cache = prefill(params, inputs)
        B = tok.shape[0]
        for k, spec in cache_specs(cfg, B, clen, ctx).items():
            sh = getattr(spec, "sharding", None)
            out[f"{c['case']}/spec/{k}"] = np.array(_spec_text(
                sh.spec if sh is not None else (), len(spec.shape)))
            if k != "pos":
                out[f"{c['case']}/out_spec/{k}"] = np.array(_spec_text(
                    cache[k].sharding.spec, cache[k].ndim))
        toks, logits = [tok], [first(params, inputs)]
        for _ in range(c["decode"]):
            logits.append(step(params, tok, cache))
            tok, cache = decode(params, tok, cache)
            toks.append(tok)
    out[f"{c['case']}/tokens"] = np.stack([np.asarray(t)[:, 0]
                                           for t in toks])
    for i, lg in enumerate(logits):
        out[f"{c['case']}/logits/{i}"] = np.asarray(lg)
    print(c["case"], [np.asarray(t)[:, 0].tolist() for t in toks],
          flush=True)


def main(cases_path, path):
    with open(cases_path) as f:
        cases = json.load(f)
    out: dict = {}
    for c in cases:
        if c.get("kind") == "serve":
            serve(c, out)
            continue
        cfg = configs.reduced(c["arch"])
        with np.load(c["weights"]) as z:
            params, batch = nested(z, "params"), nested(z, "batch")
        n = c["mesh"][0] * c["mesh"][1]
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        comp = CompressionConfig(enabled=c["compress"])
        with use_mesh_context(mesh):
            state = {"params": params, "opt": init_opt_state(params),
                     "step": jnp.int32(0)}
            if c["compress"]:
                state["err"] = init_error_state(params)
            step = jax.jit(make_train_step(cfg, OptConfig(lr=LR), comp,
                                           c["accum"]))
            state, metrics = step(state, batch)
            put(out, f"{c['case']}/metrics", metrics)
            put(out, f"{c['case']}/m", state["opt"]["m"])
        print(c["case"], float(metrics["ce"]), flush=True)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
