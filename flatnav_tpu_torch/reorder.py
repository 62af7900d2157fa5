"""Graph reordering for gather locality: Gorder and Reverse Cuthill-McKee.

Counterpart (an own copy) of flatnav_tpu/reorder.py, after the reference's
cache-locality relayout (include/flatnav/util/Reordering.h): both return a
permutation P where P[i] is the NEW id of the node currently labeled i
(Reordering.h:19-22 contract). On a CPU the payoff is cache lines; on the
card it is gather locality: neighbor rows that co-occur in beam hops land
in nearby sectors and L2 lines.

This is offline host-side preprocessing (the reference also runs it as a
standalone pass, Index::doGraphReordering, Index.h:412-427). The hot-loop
implementation lives in the native C++ library (flatnav_tpu_torch.native);
this module holds the public entry points and the pure-Python versions,
which are the tests' oracle and what runs where no compiler exists.

Both accept `links` as an [N, M] int32 array with self-loop padding (the
dense analog of the reference's outdegree_table, Index.h:240-251).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from flatnav_tpu_torch import native


def _adjacency(links: np.ndarray, n: int):
    """outdegree lists, excluding self-loop padding
    (Index::getGraphOutdegreeTable, Index.h:240-251)."""
    out = []
    for i in range(n):
        row = links[i]
        out.append(row[row != i].tolist())
    return out


class _GorderQueue:
    """Priority queue with O(1) increment/decrement/pop, mirroring
    GorderPriorityQueue.h:13-109 (sorted array + index map + priority-class
    boundaries)."""

    def __init__(self, n: int):
        self.nodes = list(range(n))  # sorted by priority ascending
        self.pos = list(range(n))  # node -> index in self.nodes
        self.prio = [0] * n
        self.present = [True] * n
        # boundaries[p] = index of first element with priority > p is
        # implicit; we track per-class right boundary lazily via scan-free
        # swap: to increment node u, swap it with the LAST node having the
        # same priority, then bump.
        self.size = n

    def _swap(self, i: int, j: int):
        a, b = self.nodes[i], self.nodes[j]
        self.nodes[i], self.nodes[j] = b, a
        self.pos[a], self.pos[b] = j, i

    def _class_end(self, i: int) -> int:
        """Index of the last element with the same priority as nodes[i]."""
        p = self.prio[self.nodes[i]]
        lo, hi = i, self.size - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.prio[self.nodes[mid]] == p:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def _class_start(self, i: int) -> int:
        p = self.prio[self.nodes[i]]
        lo, hi = 0, i
        while lo < hi:
            mid = (lo + hi) // 2
            if self.prio[self.nodes[mid]] == p:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def increment(self, u: int):
        if not self.present[u]:
            return
        i = self.pos[u]
        j = self._class_end(i)
        self._swap(i, j)
        self.prio[u] += 1

    def decrement(self, u: int):
        if not self.present[u]:
            return
        i = self.pos[u]
        j = self._class_start(i)
        self._swap(i, j)
        self.prio[u] -= 1

    def pop(self) -> int:
        u = self.nodes[self.size - 1]
        self.size -= 1
        self.present[u] = False
        return u


def gorder(links: np.ndarray, n: int, window_size: int = 5) -> np.ndarray:
    """Gorder sliding-window greedy ordering (Reordering.h:26-117).

    Returns P (int32 [n]) with P[old_id] = new_id. Uses the native C++
    implementation when available (flatnav_tpu_torch.native), else
    `gorder_python`.
    """
    native_perm = native.gorder(links, n, window_size)
    if native_perm is not None:
        return native_perm
    return gorder_python(links, n, window_size)


def gorder_python(links: np.ndarray, n: int, window_size: int = 5) -> np.ndarray:
    """`gorder` in pure Python: the oracle of the native implementation."""
    out_table = _adjacency(links, n)
    in_table = [[] for _ in range(n)]
    for u in range(n):
        for v in out_table[u]:
            in_table[v].append(u)

    q = _GorderQueue(n)
    order = np.empty(n, dtype=np.int32)
    q.increment(0)  # seed node (Reordering.h:66-68)
    order[0] = q.pop()

    for i in range(1, n):
        v_e = order[i - 1]
        for u in out_table[v_e]:
            q.increment(u)
        for u in in_table[v_e]:
            q.increment(u)
            for v in out_table[u]:
                q.increment(v)
        if i > window_size + 1:
            v_b = order[i - window_size - 1]
            for u in out_table[v_b]:
                q.decrement(u)
            for u in in_table[v_b]:
                q.decrement(u)
                for v in out_table[u]:
                    q.decrement(v)
        order[i] = q.pop()

    perm = np.empty(n, dtype=np.int32)
    perm[order] = np.arange(n, dtype=np.int32)
    return perm


def rcm_order(links: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (Reordering.h:119-200).

    BFS from min-degree roots, neighbors visited min-degree-first, final
    order reversed. Returns P with P[old_id] = new_id. Prefers the native
    C++ implementation, else `rcm_order_python`.
    """
    native_perm = native.rcm_order(links, n)
    if native_perm is not None:
        return native_perm
    return rcm_order_python(links, n)


def rcm_order_python(links: np.ndarray, n: int) -> np.ndarray:
    """`rcm_order` in pure Python: the oracle of the native implementation."""
    out_table = _adjacency(links, n)
    degrees = np.array([len(t) for t in out_table])
    roots = np.argsort(degrees, kind="stable")
    visited = np.zeros(n, dtype=bool)
    order = []

    for root in roots:
        if visited[root]:
            continue
        visited[root] = True
        order.append(int(root))
        queue = deque(sorted(out_table[root], key=lambda e: degrees[e]))
        while queue:
            cand = queue.popleft()
            if visited[cand]:
                continue
            visited[cand] = True
            order.append(cand)
            queue.extend(sorted(out_table[cand], key=lambda e: degrees[e]))

    order.reverse()
    perm = np.empty(n, dtype=np.int32)
    perm[np.array(order)] = np.arange(n, dtype=np.int32)
    return perm
