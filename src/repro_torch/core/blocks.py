"""Block-level model abstraction for partitioning.

ParetoPipe (Sec. IV-C/IV-D of the paper) partitions models at *block*
boundaries — a block is a group of layers that is never split internally
(e.g. an inverted-residual block of MobileNetV2 or a transformer layer).
The partitioner only needs, per block:

  * forward cost (FLOPs, or a measured per-device time — see CostTable),
  * parameter bytes (for the per-device memory-feasibility constraint),
  * the size of the activation it emits (what crosses the wire if we cut
    right after it).

A ``BlockGraph`` is a linear chain of blocks.  Non-chain dependencies that
matter for partitioning (whisper's encoder output feeding every decoder
block) are modelled with ``broadcast_bytes``: bytes that must additionally
be forwarded to every stage placed after this block.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class Block:
    """One indivisible unit of the model."""

    name: str
    flops: float                 # forward FLOPs per *sample*
    weight_bytes: int            # parameter bytes held by this block
    out_bytes: int               # activation bytes emitted per *sample*
    act_bytes: int = 0           # peak intermediate activation bytes (memory model)
    eff: float = 1.0             # achievable fraction of device peak (per-op-type)
    shared_group: str | None = None   # weight-sharing group id (zamba2 shared block)
    broadcast_bytes: int = 0     # bytes every *later* stage needs (enc-dec cross-attn)

    def scaled(self, batch: int) -> "Block":
        return dataclasses.replace(
            self,
            flops=self.flops * batch,
            out_bytes=self.out_bytes * batch,
            act_bytes=self.act_bytes * batch,
            broadcast_bytes=self.broadcast_bytes * batch,
        )


@dataclass(frozen=True)
class BlockGraph:
    """A linear chain of blocks plus the model-input size."""

    name: str
    blocks: tuple[Block, ...]
    input_bytes: int             # bytes of the model input per sample
    output_bytes: int = 0        # bytes of the final prediction per sample

    def __post_init__(self):
        if not self.blocks:
            raise ValueError(f"BlockGraph {self.name!r} has no blocks")

    # ------------------------------------------------------------------ #
    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def total_flops(self) -> float:
        return sum(b.flops for b in self.blocks)

    @property
    def total_weight_bytes(self) -> int:
        """Total parameter bytes, counting each shared group once."""
        seen: set[str] = set()
        total = 0
        for b in self.blocks:
            if b.shared_group is not None:
                if b.shared_group in seen:
                    continue
                seen.add(b.shared_group)
            total += b.weight_bytes
        return total

    def segment_flops(self, lo: int, hi: int) -> float:
        """FLOPs of blocks[lo:hi]."""
        return sum(b.flops for b in self.blocks[lo:hi])

    def segment_weight_bytes(self, lo: int, hi: int) -> int:
        """Parameter bytes of blocks[lo:hi]; shared groups counted once
        per segment (each stage that uses a shared block holds one copy)."""
        seen: set[str] = set()
        total = 0
        for b in self.blocks[lo:hi]:
            if b.shared_group is not None:
                if b.shared_group in seen:
                    continue
                seen.add(b.shared_group)
            total += b.weight_bytes
        return total

    def cut_bytes(self, p: int) -> int:
        """Bytes/sample crossing a cut placed after block index ``p-1``
        (i.e. blocks[0:p] on the earlier side).  ``p == 0`` means the raw
        input crosses; ``p == n_blocks`` means only the output crosses.
        Broadcast edges from any block at or before the cut add their
        bytes (they must reach the later stage too)."""
        if p <= 0:
            base = self.input_bytes
        elif p >= self.n_blocks:
            return self.output_bytes
        else:
            base = self.blocks[p - 1].out_bytes
        bcast = sum(b.broadcast_bytes for b in self.blocks[:p])
        return base + bcast

    def scaled(self, batch: int) -> "BlockGraph":
        return BlockGraph(
            name=self.name,
            blocks=tuple(b.scaled(batch) for b in self.blocks),
            input_bytes=self.input_bytes * batch,
            output_bytes=self.output_bytes * batch,
        )


def chain(name: str, blocks: Sequence[Block], input_bytes: int,
          output_bytes: int = 0) -> BlockGraph:
    return BlockGraph(name=name, blocks=tuple(blocks),
                      input_bytes=input_bytes, output_bytes=output_bytes)
