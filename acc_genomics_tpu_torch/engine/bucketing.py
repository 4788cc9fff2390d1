"""Length bucketing of PairHMM pairs.

The port of the JAX package's ``engine/bucketing.py`` (the redesign of
the reference's length sorting, FalconPairHMM.cpp sortReads): pairs are
grouped by padded (rows, cols) shape, so each group is one kernel launch
over equally shaped byte planes with one pair per thread block.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple


def _round_up(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    raise ValueError(f"length {x} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class BucketPlan:
    """Assignment of pair indices to (rows, cols) bucket shapes."""

    # (rows, cols) -> list of original pair indices
    groups: Dict[Tuple[int, int], List[int]]
    n_pairs: int

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        """The (rows, cols) shapes in use, sorted."""
        return sorted(self.groups)

    def padded_cells(self, lane_pad: int = 128) -> int:
        """Cells the launches cover when each group's pairs are padded to
        whole blocks of ``lane_pad`` lanes."""
        total = 0
        for (r, c), idxs in self.groups.items():
            blocks = -(-len(idxs) // lane_pad)
            total += blocks * lane_pad * r * c
        return total


def plan_buckets(
    read_lens: Sequence[int],
    hap_lens: Sequence[int],
    read_buckets: Sequence[int],
    hap_buckets: Sequence[int],
) -> BucketPlan:
    """Group pairs by padded shape.

    read bucket must exceed the read length (>= 1 absorbing row), so a
    read of length L needs a bucket with rows > L.
    """
    groups: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for k, (rl, hl) in enumerate(zip(read_lens, hap_lens)):
        rows = _round_up(rl + 1, read_buckets)
        cols = _round_up(hl, hap_buckets)
        groups[(rows, cols)].append(k)
    return BucketPlan(dict(groups), len(read_lens))
