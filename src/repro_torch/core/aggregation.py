"""Eq. (1) participation counts (counterpart of
``repro/core/aggregation.py:participation_counts``; the cross-layer
aggregation of the engines waits for the paper's loop, ROADMAP.md Queue 1
item 3)."""
from __future__ import annotations

from typing import List, Sequence, Tuple


def participation_counts(split_layers: Sequence[int], num_layers: int
                         ) -> Tuple[List[int], List[int]]:
    """For each 0-indexed layer l: (#clients with l client-side,
    #clients with l server-side).  Client i holds layers [0, l_i)."""
    n_client = [sum(1 for s in split_layers if l < s)
                for l in range(num_layers)]
    n_server = [len(split_layers) - c for c in n_client]
    return n_client, n_server
