"""Shared code for the port's gateway tests: the per-tenant requests
(numpy, seeded), a solo run of each tenant through its own gateway (the
bit-identity baseline), and the check that a mixed run gave every
tenant its solo bits in submit order.
"""
import numpy as np
import torch

from repro_torch.core import scenarios
from repro_torch.runtime import Gateway, drain_qos

MAX_BATCH = 8
N_REQS = 3                                    # requests per tenant
NAMES = [f"tenant{i}" for i in range(8)]


def requests() -> dict[str, list[np.ndarray]]:
    """The same per-tenant requests for every run — distinct per
    (tenant, req) so leakage or reordering shows in the bits."""
    return {n: [np.random.default_rng(1000 + 10 * i + j).standard_normal(
                    (1, 32, 32, 3)).astype(np.float32)
                for j in range(N_REQS)]
            for i, n in enumerate(NAMES)}


def tensors(reqs) -> dict[str, list[torch.Tensor]]:
    return {n: [torch.from_numpy(x) for x in xs] for n, xs in reqs.items()}


def solo(pipe, reqs, names=NAMES):
    """Each tenant served alone through its own gateway, with the same
    ``max_batch`` padding as every mixed run → {tenant: [(req_id, y)]}."""
    refs = {}
    for n in names:
        with Gateway(pipe, [scenarios.TenantSpec(n)], max_batch=MAX_BATCH,
                     batch_window_s=0.0) as gw:
            c = gw.client(n)
            for x in reqs[n]:
                c.submit(x)
            refs[n] = c.drain()
        assert [r for r, _ in refs[n]] == list(range(N_REQS))
    drain_qos()
    return refs


def assert_solo_bits(got, refs, names, what):
    """Every tenant of ``names``: all its requests, in submit order,
    each ``torch.equal`` to its solo result."""
    for n in names:
        assert [r for r, _ in got[n]] == list(range(N_REQS))
        for (_, y), (_, ref) in zip(got[n], refs[n]):
            assert torch.equal(y, ref), \
                f"tenant {n} leaked or corrupted under {what}"
