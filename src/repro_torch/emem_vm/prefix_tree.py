"""Radix-tree prefix index over prompt token ids.

The structure-in-the-memory move, applied to prefix *matching*: instead of
scanning every retained entry and live prompt from outside (O(pool) numpy
compares per admission-cost query, re-run for every waiting request on
every decode step), the prompts themselves are stored as a compressed
radix tree (trie with path compression).  Every edge spans a run of token
ids; a node's path from the root is the longest common prefix of every
prompt in its subtree, so pages of ``page_slots`` tokens align to whole
edge spans and one partial-page tail per terminal.  Lookup walks the query
once -- O(prompt length) regardless of how many prompts or retained
entries exist -- and partially-overlapping prompts (hot system prompt +
divergent few-shot tails) meet at the interior node where they split.

Two kinds of *terminals* hang off nodes:

  * a **pool terminal** -- a retained completed prompt.  It owns the
    refcounted ``(lpage, frame)`` page list the retention pool used to
    keep in ``_RetainEntry`` (prompts that share a token prefix share the
    underlying frames whenever sharing was on when they were admitted, so
    an interior node's span *is* a shared frame range -- but correctness
    never assumes it: the refcounts are per-terminal).
  * **live terminals** -- sequences currently decoding, mirroring
    ``BlockManager._prompts``.  They own no pages here; the block table
    does.

The tie-break contract replicates the linear scan byte-for-byte (the
linear matcher stays behind ``prefix_index="linear"`` for a while as the
differential-test oracle): the retention pool is consulted first in LRU
order, a live donor only wins with a strictly longer match, and equal
matches resolve to the earliest entry in iteration order.  In the tree,
every candidate with the maximum common prefix lives in one *stop
subtree* (where the query's descent ended), so the winner is simply the
stamp-minimal pool terminal of that subtree, else its stamp-minimal live
terminal.  Stamps come from one monotone clock: insertion and LRU
``touch`` assign a fresh stamp, so ascending stamp == OrderedDict
iteration order, and each node carries ``(stamp, id)`` subtree-minimum
aggregates maintained on the path to the root -- lookup never visits a
subtree, it reads the aggregate at the stop node.

The pool side also maintains what the ownership layer's reclaim policy
needs without O(pool) walks: an LRU key order, a total-frames counter,
and a per-frame reference count over pool-held pages so
``reclaimable()`` touches each *distinct* frame once instead of every
page of every entry.
"""
from __future__ import annotations

import collections

import numpy as np


class _Node:
    """One radix-tree node: ``edge`` is the token run on the incoming
    edge (empty at the root), ``children`` keys by the first token of
    each outgoing edge.  ``best_pool``/``best_live`` are ``(stamp, id)``
    minima over the whole subtree (None when the subtree holds no
    terminal of that kind)."""
    __slots__ = ("edge", "children", "parent", "pool", "live",
                 "best_pool", "best_live")

    def __init__(self, edge: np.ndarray, parent: "_Node | None"):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.parent = parent
        self.pool: tuple[int, int] | None = None    # (key, stamp)
        self.live: dict[int, int] = {}              # seq -> stamp
        self.best_pool: tuple[int, int] | None = None   # (stamp, key)
        self.best_live: tuple[int, int] | None = None   # (stamp, seq)


class PrefixTree:
    def __init__(self, page_slots: int):
        self.page_slots = page_slots
        self._root = _Node(np.empty(0, np.int32), None)
        self._clock = 0
        #: pool key -> (terminal node, tokens, [(lpage, frame), ...])
        self._pool: dict[int, tuple[_Node, np.ndarray, list]] = {}
        #: pool keys in LRU order (first = coldest), mirrors the retired
        #: ``_retained`` OrderedDict's order exactly
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._live: dict[int, _Node] = {}           # seq -> terminal node
        #: pool-held references per distinct frame (reclaim accounting)
        self._frame_counts: dict[int, int] = {}
        #: total pages across all pool terminals (the retention budget)
        self.pool_frames_total = 0
        self.n_nodes = 1

    # -- structure ------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _split(self, child: _Node, k: int) -> _Node:
        """Split ``child``'s incoming edge at offset ``k``: a new upper
        node takes ``edge[:k]``, ``child`` keeps the rest below it.  The
        upper node inherits the subtree aggregates unchanged (same
        subtree, one more interior node)."""
        parent = child.parent
        upper = _Node(child.edge[:k].copy(), parent)
        parent.children[int(upper.edge[0])] = upper
        child.edge = child.edge[k:].copy()
        child.parent = upper
        upper.children[int(child.edge[0])] = child
        upper.best_pool = child.best_pool
        upper.best_live = child.best_live
        self.n_nodes += 1
        return upper

    def _node_for(self, tokens: np.ndarray) -> _Node:
        """The node whose root path is exactly ``tokens``, creating leaves
        and splitting edges as needed."""
        node, i, n = self._root, 0, len(tokens)
        while i < n:
            child = node.children.get(int(tokens[i]))
            if child is None:
                leaf = _Node(tokens[i:].copy(), node)
                node.children[int(tokens[i])] = leaf
                self.n_nodes += 1
                return leaf
            e = child.edge
            m = min(len(e), n - i)
            eq = e[:m] == tokens[i:i + m]
            k = m if eq.all() else int(np.argmin(eq))
            if k < len(e):
                child = self._split(child, k)
            node = child
            i += k
        return node

    def _exact_node(self, tokens: np.ndarray) -> _Node | None:
        """The existing node at exactly ``tokens`` -- None if the path is
        absent or ends mid-edge.  Never mutates the tree."""
        node, i, n = self._root, 0, len(tokens)
        while i < n:
            child = node.children.get(int(tokens[i]))
            if child is None:
                return None
            e = child.edge
            if len(e) > n - i or (e != tokens[i:i + len(e)]).any():
                return None
            node = child
            i += len(e)
        return node

    def _recompute(self, node: _Node) -> bool:
        bp = None
        if node.pool is not None:
            key, stamp = node.pool
            bp = (stamp, key)
        bl = min(((st, sq) for sq, st in node.live.items()), default=None)
        for c in node.children.values():
            if c.best_pool is not None and (bp is None or c.best_pool < bp):
                bp = c.best_pool
            if c.best_live is not None and (bl is None or c.best_live < bl):
                bl = c.best_live
        changed = bp != node.best_pool or bl != node.best_live
        node.best_pool, node.best_live = bp, bl
        return changed

    def _pull_up(self, node: _Node) -> None:
        """Recompute subtree aggregates from ``node`` up to the root,
        stopping early once nothing changes (ancestors see this subtree
        only through the aggregate)."""
        while node is not None:
            if not self._recompute(node):
                break
            node = node.parent

    def _prune(self, node: _Node) -> None:
        """After a terminal was removed at ``node``: delete childless
        terminal-less leaves and merge single-child pass-through nodes
        (concatenate edges) so the tree stays a *compressed* trie, then
        repair aggregates up the remaining path."""
        while node is not self._root:
            parent = node.parent
            if node.pool is None and not node.live:
                if not node.children:
                    del parent.children[int(node.edge[0])]
                    self.n_nodes -= 1
                    node = parent
                    continue
                if len(node.children) == 1:
                    (child,) = node.children.values()
                    child.edge = np.concatenate([node.edge, child.edge])
                    child.parent = parent
                    parent.children[int(child.edge[0])] = child
                    self.n_nodes -= 1
                    node = parent
                    continue
            break
        self._pull_up(node)

    # -- lookup ---------------------------------------------------------------
    def lookup(self, tokens) -> tuple[int, tuple[str, int] | None]:
        """Longest common prefix of ``tokens`` with any stored prompt.

        Returns ``(match_len, donor)`` with donor ``("pool", key)`` or
        ``("live", seq)`` -- ``(0, None)`` when nothing matches.  One
        descent, O(len(tokens)): every candidate achieving the maximum
        match lives in the subtree where the descent stopped, so the
        donor is that node's pool aggregate (pool outranks live at equal
        match, exactly the linear scan's pool-first/strictly-longer
        contract), else its live aggregate -- ties inside a kind resolve
        to the minimal stamp, i.e. the earliest entry in the retired
        OrderedDict/dict iteration order."""
        tokens = np.asarray(tokens, np.int32).ravel()
        node, i, n = self._root, 0, len(tokens)
        while i < n:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            e = child.edge
            m = min(len(e), n - i)
            eq = e[:m] == tokens[i:i + m]
            k = m if eq.all() else int(np.argmin(eq))
            i += k
            node = child
            if k < len(e):      # diverged (or query ended) mid-edge: the
                break           # stop subtree is this child's subtree
        if i == 0:
            return 0, None
        if node.best_pool is not None:
            return i, ("pool", node.best_pool[1])
        if node.best_live is not None:
            return i, ("live", node.best_live[1])
        return 0, None          # unreachable while invariants hold

    # -- live terminals -------------------------------------------------------
    def insert_live(self, seq: int, tokens) -> None:
        tokens = np.asarray(tokens, np.int32).ravel()
        if len(tokens) == 0:
            return
        if seq in self._live:
            self.remove_live(seq)
        node = self._node_for(tokens)
        node.live[seq] = self._tick()
        self._live[seq] = node
        self._pull_up(node)

    def remove_live(self, seq: int) -> None:
        node = self._live.pop(seq, None)
        if node is None:
            return
        del node.live[seq]
        self._prune(node)

    # -- pool terminals (the retention pool) ----------------------------------
    def insert_pool(self, key: int, tokens, pages: list) -> None:
        tokens = np.asarray(tokens, np.int32).ravel()
        node = self._node_for(tokens)
        if node.pool is not None:
            raise ValueError(
                f"pool terminal already present (key {node.pool[0]}); "
                f"dedupe with find_pool first")
        node.pool = (key, self._tick())
        self._pool[key] = (node, tokens.copy(), list(pages))
        self._lru[key] = None
        self.pool_frames_total += len(pages)
        for _, f in pages:
            self._frame_counts[f] = self._frame_counts.get(f, 0) + 1
        self._pull_up(node)

    def remove_pool(self, key: int) -> list:
        """Detach and return the pages of pool terminal ``key`` (the
        caller owns the derefs)."""
        node, _, pages = self._pool.pop(key)
        del self._lru[key]
        node.pool = None
        self.pool_frames_total -= len(pages)
        for _, f in pages:
            c = self._frame_counts[f] - 1
            if c:
                self._frame_counts[f] = c
            else:
                del self._frame_counts[f]
        self._prune(node)
        return pages

    def touch_pool(self, key: int) -> None:
        """LRU touch: move ``key`` to most-recently-used and restamp its
        terminal (== the OrderedDict ``move_to_end`` the linear pool
        did)."""
        node, _, _ = self._pool[key]
        self._lru.move_to_end(key)
        node.pool = (key, self._tick())
        self._pull_up(node)

    def find_pool(self, tokens) -> int | None:
        """Key of the pool terminal holding exactly ``tokens`` (the
        dedupe probe), None if absent."""
        tokens = np.asarray(tokens, np.int32).ravel()
        node = self._exact_node(tokens)
        if node is not None and node.pool is not None:
            return node.pool[0]
        return None

    def pool_pages(self, key: int) -> list:
        return self._pool[key][2]

    def lru_keys(self) -> list[int]:
        """Pool keys, coldest first."""
        return list(self._lru)

    def oldest_pool(self) -> int:
        return next(iter(self._lru))

    @property
    def pool_count(self) -> int:
        return len(self._pool)

    # -- reclaim accounting ---------------------------------------------------
    def reclaimable(self, allocator, exclude_key: int | None = None) -> int:
        """Device frames draining the pool would free: frames whose every
        allocator reference is pool-held (and unpinned), excluding the
        entry ``exclude_key`` an admission intends to share from.  O(#
        distinct pool frames) via the maintained per-frame counts."""
        excl: dict[int, int] = {}
        if exclude_key is not None and exclude_key in self._pool:
            for _, f in self._pool[exclude_key][2]:
                excl[f] = excl.get(f, 0) + 1
        n = 0
        for f, c in self._frame_counts.items():
            c -= excl.get(f, 0)
            if (c > 0 and allocator.refcount(f) == c
                    and allocator.pin_count(f) == 0):
                n += 1
        return n
