"""Collective inventory and wire bytes of a step (counterpart of
``src/repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO text of a compiled step: every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, its result bytes, its group size, and whether the
group crosses a pod boundary (DCN) or stays inside (ICI).  PyTorch runs
eagerly and has no HLO, so the port has no counterpart of the parser
(``parse_collectives`` and its regexes): ``CollectiveRecorder``, a
``TorchDispatchMode``, records the same facts of every collective as
the step issues it — the ``_c10d_functional`` ops DTensor's
redistributions run, its ``_dtensor.shard_dim_alltoall`` (a
``Shard(i)`` → ``Shard(j)`` move on one mesh dim, one op to a dispatch
mode) and the ``c10d`` ops of ``torch.distributed``'s calls
(``all_reduce`` inside the steps' local functions), each under the
reference's kind name (send/recv as ``collective-permute``), with
its result bytes and its process group's size.  It works the same on a
real group and on a fake one inside ``FakeTensorMode`` (the dry run).
Given the ranks of a pod (``pod_size``: a ``(pod, data, model)`` mesh's
pods are blocks of that many consecutive ranks), it marks each
collective whose group's global ranks lie in more than one pod, and each
send or receive whose peer lies in another, as ``crosses_pod`` (the
reference's DCN); without it none crosses.

Wire-byte model per device (ring/bidirectional algorithms), the
reference's ``_wire_bytes``:
  all-gather       T·(s-1)/s        (T = full gathered tensor = result)
  reduce-scatter   T_in·(s-1)/s     (T_in = s · result)
  all-reduce       2·T·(s-1)/s      (RS + AG over the full tensor)
  all-to-all       T·(s-1)/s
  collective-permute  T             (point-to-point)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (without its overload) → kind; the list-of-tensors c10d ops
# and the functional "coalesced" ops carry several results
KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# the argument that holds each c10d op's result (the first, else)
_RESULT_ARG = {"allgather_": 0, "_allgather_base_": 0, "reduce_scatter_": 0,
               "_reduce_scatter_base_": 0, "alltoall_": 0,
               "alltoall_base_": 0}


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    crosses_pod: bool
    wire_bytes: int      # per-device wire traffic


@dataclass
class CollectiveSummary:
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(o.result_bytes for o in self.ops)

    @property
    def wire_bytes_ici(self) -> int:
        return sum(o.wire_bytes for o in self.ops if not o.crosses_pod)

    @property
    def wire_bytes_dcn(self) -> int:
        return sum(o.wire_bytes for o in self.ops if o.crosses_pod)

    def by_kind(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for o in self.ops:
            d = out.setdefault(o.kind, {"count": 0, "bytes": 0, "wire": 0})
            d["count"] += 1
            d["bytes"] += o.result_bytes
            d["wire"] += o.wire_bytes
        return out

    def by_kind_and_pod(self) -> dict[str, dict]:
        """``by_kind``'s count and bytes, each kind split in two:
        ``<kind>/crossing`` the ops whose group crosses a pod,
        ``<kind>/within`` the others."""
        out: dict[str, dict] = {}
        for o in self.ops:
            key = f"{o.kind}/{'crossing' if o.crosses_pod else 'within'}"
            d = out.setdefault(key, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += o.result_bytes
        return out


def _wire_bytes(kind: str, result_bytes: int, s: int) -> int:
    if s <= 1:
        return 0
    if kind == "all-gather":
        return int(result_bytes * (s - 1) / s)
    if kind == "reduce-scatter":
        return int(result_bytes * (s - 1))
    if kind == "all-reduce":
        return int(2 * result_bytes * (s - 1) / s)
    if kind == "all-to-all":
        return int(result_bytes * (s - 1) / s)
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group(args, kwargs):
    """The op's process group: a functional op names it (``group_name``),
    a c10d op passes the ``ProcessGroup`` (boxed, in the dispatcher) →
    it, or None."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in (*args, *kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:        # another boxed class (a ReduceOp)
                continue
    return None


def _crosses(group, name: str, args, pod_size: int | None) -> bool:
    """Whether the op's group spans more than one pod; for a send or a
    receive (whose third argument is the peer's rank in the group),
    whether the peer lies in another pod than this rank."""
    import torch.distributed as dist
    if pod_size is None or group is None:
        return False
    ranks = dist.get_process_group_ranks(group)
    if name in ("send", "recv_"):
        ranks = [dist.get_rank(), ranks[args[2]]]
    return len({r // pod_size for r in ranks}) > 1


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec: step(...)`` → ``rec.summary``,
    every collective the step issued, in order; ops of no bytes (a
    barrier) are skipped, as the reference's parser skips them.  With
    ``pod_size`` each is marked crossing pods or not."""

    def __init__(self, pod_size: int | None = None):
        super().__init__()
        self.summary = CollectiveSummary()
        self.pod_size = pod_size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            name = func.overloadpacket.__name__
            kind = KINDS.get(name)
            if kind is not None:
                if func.namespace == "c10d":
                    res = args[_RESULT_ARG.get(name, 0)]
                else:
                    res = out
                rb = _tensor_bytes(res)
                if rb:
                    group = _group(args, kwargs)
                    s = 1 if group is None else group.size()
                    self.summary.ops.append(CollectiveOp(
                        kind=kind, result_bytes=rb, group_size=s,
                        crosses_pod=_crosses(group, name, args,
                                             self.pod_size),
                        wire_bytes=_wire_bytes(kind, rb, s)))
        return out
