"""Shared fixture code for the port's process-transport tests: the
reference tests' ``tinycnn`` built in both packages with the same weights
(``from_reference``), seeded batches, the reference's ``CNNModel.apply``
outputs for them, and a supervised run under a fault plan.

Every output is held to the reference within ``ATOL`` = 1e-5 (fp32 sums
in a different order, as in ``test_torch_cnn.py``); a lost, duplicated
or reordered batch misses it by far more.
"""
import jax
import numpy as np
import torch

from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import EdgePipeline

ATOL = 1e-5


def _tiny(lib, zoo):
    blocks = [
        ("conv0", lib.Sequential([lib.Conv2D(3, 8, 3, 1, 1), lib.ReLU()])),
        ("conv1", lib.Sequential([lib.Conv2D(8, 8, 3, 1, 1), lib.ReLU()])),
        ("pool", lib.Pool("max", 2, 2)),
        ("conv2", lib.Sequential([lib.Conv2D(8, 16, 3, 1, 1), lib.ReLU()])),
        ("head", lib.Sequential([lib.Flatten(), lib.Linear(16 * 16 * 16, 10)])),
    ]
    return zoo.CNNModel("tinycnn", blocks, input_hw=32)


def tiny_models():
    """→ (reference model, its params, the port's model with them)."""
    ref = _tiny(RL, RZ)
    params = ref.init(jax.random.PRNGKey(0))
    port = _tiny(L, Z).from_reference(jax.tree.map(np.asarray, params))
    return ref, params, port


def batches(n: int, seed: int = 100, batch: int = 2, hw: int = 32):
    """``n`` input batches, batch ``i`` drawn from seed ``seed + i``."""
    return [np.random.default_rng(seed + i).standard_normal(
        (batch, hw, hw, 3)).astype(np.float32) for i in range(n)]


def references(models, xs) -> list[np.ndarray]:
    ref, params, _ = models
    return [np.asarray(ref.apply(params, x)) for x in xs]


def check(got, refs, what: str) -> None:
    """Every result there, in order, each within ATOL of the reference."""
    assert len(got) == len(refs), f"lost/duplicated under {what}"
    for i, (y, want) in enumerate(zip(got, refs)):
        assert np.allclose(np.asarray(y), want, rtol=0, atol=ATOL), \
            f"batch {i} wrong under {what} (reordered?)"


def run_with_plan(models, transport, plan, replicas=None, policy="drain",
                  n=8, **kw):
    """Stream ``n`` batches through a supervised 2-stage CPU pipeline
    under ``plan`` → (ordered outputs, references); ``kw`` reaches the
    pipeline (a ``spy`` callable, if given, sees the open pipeline)."""
    _, _, port = models
    xs = batches(n)
    refs = references(models, xs)
    spy = kw.pop("spy", None)
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], transport=transport,
                        replicas=replicas, fault_plan=plan,
                        stall_timeout_s=2.0, timeout_s=120, sanitize=True,
                        device="cpu", **kw)
    with pipe:
        pipe.warmup(torch.from_numpy(xs[0]))
        with pipe.session(policy=policy) as s:
            for x in xs:
                s.submit(torch.from_numpy(x))
            outs = s.drain()
        if spy is not None:
            spy(pipe)
    return [y.numpy() for y in outs], refs
