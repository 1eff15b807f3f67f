"""The port's sharding rules (``repro_torch.sharding.api``) and the spec
builder (``models.common.param_specs``) held to the JAX reference's, in
process and with no devices: each package's ``MeshContext`` over a
stand-in mesh that has only axis names and a ``devices`` array of the
mesh's shape.  The rules table is equal as a dict; ``spec`` agrees for
every rule name at every mesh below; ``zero1_spec``, ``attn_q_names``
and ``kv_cache_names`` agree for every architecture's head counts; and
every parameter of all ten architectures at full size gets the
reference ``SpecBuilder``'s spec of its leaf (a block's, its stacked
leaf's without the ``layers`` dim), row-parallel attention included.
"""
from types import SimpleNamespace

import numpy as np
import pytest
from jax.sharding import PartitionSpec

import repro.configs as RCFG
import repro.sharding.api as RS
from repro.models import lm as RL
from repro.models.common import SpecBuilder
from repro_torch import configs
from repro_torch.models.common import param_placements, param_specs
from repro_torch.optim.adamw import reference_leaf
from repro_torch.sharding import api as S
from repro_torch.sharding.api import Replicate, Shard

MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (1, 3), (16, 16)]
SHAPES = [1, 2, 3, 4, 6, 8, 12, 16, 36, 48, 64, 256, 151936]


def _stub(shape):
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(shape, object))


class _Both:
    """Both packages' contexts on a stand-in mesh of ``shape``, each set
    as its package's current context while open."""

    def __init__(self, shape):
        self.ref = RS.MeshContext(_stub(shape))
        self.port = S.MeshContext(_stub(shape))

    def __enter__(self):
        RS.set_context(self.ref)
        S.set_context(self.port)
        return self

    def __exit__(self, *exc):
        RS.set_context(None)
        S.set_context(None)


def test_rules_are_the_references():
    assert S.RULES == RS.RULES


@pytest.mark.parametrize("shape", MESHES)
def test_spec_and_placements_match_reference(shape):
    with _Both(shape) as c:
        assert c.port.axis_sizes == c.ref.axis_sizes
        for name in [*RS.RULES, None, "not-a-rule"]:
            for d0 in SHAPES:
                for d1 in (2, 3, 16):
                    logical = (name, "embed") if name != "embed" \
                        else (name, "vocab")
                    want = tuple(c.ref.spec(logical, (d0, d1)))
                    got = c.port.spec(logical, (d0, d1))
                    assert got == want, (shape, logical, d0, d1)
                    assert c.port.spec(logical) == tuple(c.ref.spec(logical))
                    placements = c.port.placements(logical, (d0, d1))
                    for axis, p in zip(("data", "model"), placements):
                        dims = [i for i, a in enumerate(got) if a == axis]
                        split = dims and c.port.size(axis) > 1
                        assert p == (Shard(dims[0]) if split
                                     else Replicate())


def _heads():
    seen = set()
    for name in configs.ARCH_NAMES:
        for cfg in (configs.get(name), configs.reduced(name)):
            seen.add((cfg.n_heads, cfg.n_kv_heads, cfg.hd))
    return sorted(seen)


@pytest.mark.parametrize("shape", MESHES)
def test_zero1_and_head_names_match_reference(shape):
    specs = [(), (None,), ("model",), (None, "model"), ("model", None),
             ("data", None), (None, None, "model"), (None, "model", None)]
    with _Both(shape):
        for H, KV, hd in _heads():
            assert S.attn_q_names(H) == RS.attn_q_names(H), (H, shape)
            assert S.kv_cache_names(KV, hd) == RS.kv_cache_names(KV, hd)
            for spec in specs:
                for dims in ((H,), (KV, hd), (hd, H, KV), (2, H, hd)):
                    dims = dims + (hd,) * (len(spec) - len(dims))
                    want = tuple(RS.zero1_spec(PartitionSpec(*spec), dims))
                    assert S.zero1_spec(spec, dims) == want, (spec, dims)


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference_spec_builder(arch, shape):
    with _Both(shape) as c:
        ref = RL.build_params(RCFG.get(arch), SpecBuilder(c.ref))
    port = param_specs(configs.get(arch), S.MeshContext(_stub(shape)))
    want = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[f"{prefix}{k}"] = tuple(v)
    walk(ref, "")
    covered = set()
    for name, spec in port.items():
        leaf, stacked = reference_leaf(name)
        covered.add(leaf)
        assert want[leaf] == ((None, *spec) if stacked else spec), name
    assert covered == set(want)
    placements = param_placements(configs.get(arch),
                                  S.MeshContext(_stub(shape)))
    assert set(placements) == set(port)
    if arch == "starcoder2-7b" and shape == (16, 16):
        # 36 heads on 16-way model: the projections shard their
        # contraction dims instead (row-parallel)
        assert port["layers.0.attn.wq"] == ("model", None, None)
        assert port["layers.0.attn.wo"] == (None, "model", None)
