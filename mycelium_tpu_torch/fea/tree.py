"""Spanning-forest elimination schedule, host side (numpy copy of
``mycelium_tpu/fea/tree.py``: ``spanning_forest``, ``build_tree_schedule``
and ``element_k3``, with the same native fast paths).

The element graph of a mycelium mesh is a spanning forest plus a few
anastomosis edges. The preconditioner eliminates the forest exactly,
scheduled here once per mesh into levels of

  paths       maximal runs of degree<=2 nodes  -> block-tridiagonal solves
                                                  (parallel cyclic reduction
                                                  on the device)
  junctions   degree>=3 nodes                  -> receive 3x3 Schur
                                                  corrections, recurse

Fracture and anchor pinning flow through the static schedule as numeric
masks; the schedule never changes for a given mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mycelium_tpu.native import meshio_native

# ---------------------------------------------------------------------------
# spanning forest
# ---------------------------------------------------------------------------

def spanning_forest(conn: np.ndarray, n_nodes: int) -> np.ndarray:
    """Stable union-find spanning forest. Returns (E,) bool: edge is in the
    forest. Non-forest edges are exactly the cycle-closing (anastomosis)
    edges; the preconditioner ignores them.

    Dispatches to the native C++ runtime (native/meshio.cpp
    meshio_spanning_forest, same edge-order union-find) when available."""
    native = meshio_native.spanning_forest(conn, n_nodes)
    if native is not None:
        return native
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    tree = np.zeros(len(conn), dtype=bool)
    for e, (a, b) in enumerate(np.asarray(conn, np.int64)):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            tree[e] = True
    return tree


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

KIND_NONE = 0
KIND_ELEM = 1
KIND_FILL = 2


class TreeLevel(NamedTuple):
    """One elimination level. All slot-indexed arrays have length S (slots,
    i.e. nodes eliminated at this level, concatenated path by path)."""
    slots: np.ndarray          # (S,) node ids
    path_start: np.ndarray     # (S,) bool — slot starts a new path
    # edge between slot i-1 and slot i (within a path):
    left_kind: np.ndarray      # (S,) int8 KIND_*  (NONE at path starts)
    left_id: np.ndarray        # (S,) int32 element id or fill id
    left_flip: np.ndarray      # (S,) bool — stored fill B is (slot_i ->
                               # slot_{i-1}); element k is symmetric
    # per-path arrays (length P):
    first_pos: np.ndarray      # (P,) slot index of path's first node
    last_pos: np.ndarray       # (P,) slot index of path's last node
    # attachments: junction neighbor of first/last node (or none)
    att_kind: np.ndarray       # (P, 2) int8 KIND_*
    att_id: np.ndarray         # (P, 2) int32
    att_flip: np.ndarray       # (P, 2) bool — True if stored edge value is
                               # oriented (slot -> junction); we want
                               # B[j, s] = K[junction, slot]
    att_level: np.ndarray      # (P, 2) int32 level of the junction's slot
    att_pos: np.ndarray        # (P, 2) int32 slot index within that level
    fill_out: np.ndarray       # (P,) int32 fill id produced (-1 if < 2
                               # attachments)


class TreeSchedule(NamedTuple):
    conn: np.ndarray           # (E, 2) int32
    tree_edge: np.ndarray      # (E,) bool — spanning forest membership
    free: np.ndarray           # (N,) bool — grip-free nodes (schedule-time)
    levels: tuple              # tuple[TreeLevel]
    n_fill: int

    @property
    def n_nodes(self) -> int:
        return len(self.free)


def build_tree_schedule(conn: np.ndarray, n_nodes: int,
                        free: np.ndarray,
                        max_path_len: int = 0) -> TreeSchedule:
    """Simulate the peel on the host and record the static schedule.

    Levels repeat until no free node remains: nodes whose degree in the
    current (free-free) forest is <= 2 form maximal paths and are
    eliminated; their Schur complements flow to the junction endpoints as
    3x3 diag corrections plus one 'fill' edge joining the two junctions.
    A forest always peels to empty (every tree has leaves).

    ``max_path_len`` > 0 chops longer paths by DEMOTING every
    (max_path_len+1)-th node to the next level: the demoted nodes become
    this level's junctions and are chained together by the adjacent
    chunks' fill edges, i.e. ordinary two-level cyclic reduction. This
    bounds the device PCR round count r = ceil(log2(max path len)) — the
    dominant VMEM term of the whole-solve kernel scales linearly in r."""
    conn = np.asarray(conn, np.int64)
    free = np.asarray(free, bool)
    tree_edge = spanning_forest(conn, n_nodes)

    # native C++ peel (identical semantics, tested against the python walk
    # below — which stays as the fallback and the equality oracle): the
    # python path walk costs minutes at 1e6 nodes, the native one ~1 s
    native = meshio_native.tree_peel(conn, n_nodes, tree_edge, free,
                                     max_path_len)
    if native is not None:
        lvl_dicts, n_fill_native = native
        lvls = tuple(TreeLevel(**d) for d in lvl_dicts)
        return TreeSchedule(conn=np.asarray(conn, np.int32),
                            tree_edge=np.asarray(tree_edge, bool),
                            free=free, levels=lvls,
                            n_fill=n_fill_native)

    # adjacency over free-free tree edges: adj[node] = list of (nbr, kind,
    # id, flip) — flip=True means the stored value is oriented (nbr, node)
    adj = [[] for _ in range(n_nodes)]
    for e in np.nonzero(tree_edge)[0]:
        a, b = conn[e]
        if free[a] and free[b] and a != b:
            adj[a].append([b, KIND_ELEM, int(e), False])
            adj[b].append([a, KIND_ELEM, int(e), False])
    # flat edge arrays for the vectorized per-level degree count (the
    # python-loop version cost O(alive) list scans per level — ~40% of a
    # 1e6-node host build); fill edges created during the peel are
    # appended via fill_a/fill_b
    te = np.nonzero(tree_edge)[0]
    ea_, eb_ = conn[te, 0], conn[te, 1]
    keep = free[ea_] & free[eb_] & (ea_ != eb_)
    edge_a, edge_b = ea_[keep], eb_[keep]
    fill_a: list = []
    fill_b: list = []

    alive = free.copy()
    levels = []
    n_fill = 0
    # node -> (level, pos) assignment, filled as nodes are eliminated
    node_level = np.full(n_nodes, -1, np.int32)
    node_pos = np.full(n_nodes, -1, np.int32)
    # deferred attachment targets: attachments point at junctions that are
    # eliminated at LATER levels, so patch (att_level, att_pos) afterwards
    pending = []   # (level_idx, path_idx, side, junction_node)

    level_idx = 0
    while alive.any():
        if fill_a:
            edge_a = np.concatenate([edge_a, np.asarray(fill_a, np.int64)])
            edge_b = np.concatenate([edge_b, np.asarray(fill_b, np.int64)])
            fill_a, fill_b = [], []
        m = alive[edge_a] & alive[edge_b]
        deg = np.bincount(edge_a[m], minlength=n_nodes) \
            + np.bincount(edge_b[m], minlength=n_nodes)
        elim = alive & (deg <= 2)
        if not elim.any():   # cannot happen on a forest
            raise RuntimeError("tree peel stuck: non-forest structure")

        slots, path_start = [], []
        lkind, lid, lflip = [], [], []
        first_pos, last_pos = [], []
        att_kind, att_id, att_flip = [], [], []
        fill_out = []
        visited = np.zeros(n_nodes, bool)

        def walk(start, avoid):
            """Follow unvisited elim nodes from `start`, never stepping
            back to `avoid`; returns the node list (excluding start)."""
            out = []
            cur, prev = start, avoid
            while True:
                nxt = -1
                for nb in adj[cur]:
                    if alive[nb[0]] and elim[nb[0]] and nb[0] != prev \
                            and not visited[nb[0]]:
                        nxt = nb[0]
                        break
                if nxt < 0:
                    return out
                visited[nxt] = True
                out.append(nxt)
                prev, cur = cur, nxt

        def _emit_path(nodes):
            """Record one path's slots, left edges, attachments and fill."""
            nonlocal n_fill
            # edge between consecutive path nodes, with orientation flag
            # relative to (nodes[i-1] -> nodes[i]): adjacency entries are
            # [nbr, kind, id, flip] with flip=False iff the stored value
            # is oriented (this_node -> nbr)
            edges = []
            for i in range(1, len(nodes)):
                a, b = nodes[i - 1], nodes[i]
                for nb in adj[a]:
                    if nb[0] == b:
                        edges.append((nb[1], nb[2], nb[3]))
                        break
                else:
                    raise RuntimeError("path edge missing")

            p = len(first_pos)
            base = len(slots)
            for i, nnode in enumerate(nodes):
                slots.append(nnode)
                path_start.append(i == 0)
                if i == 0:
                    lkind.append(KIND_NONE)
                    lid.append(0)
                    lflip.append(False)
                else:
                    k, eid, fl = edges[i - 1]
                    lkind.append(k)
                    lid.append(eid)
                    # left edge value wanted as K[slot_{i-1}, slot_i]
                    # (orientation prev -> cur); stored (a->b) with a =
                    # nodes[i-1] when flip False
                    lflip.append(fl)
                node_level[nnode] = level_idx
                node_pos[nnode] = base + i
            first_pos.append(base)
            last_pos.append(base + len(nodes) - 1)

            # attachments: alive non-elim neighbors of the path ends
            pk = [KIND_NONE, KIND_NONE]
            pi = [0, 0]
            pf = [False, False]
            juncs = [None, None]
            for side, endn in ((0, nodes[0]), (1, nodes[-1])):
                cands = [nb for nb in adj[endn]
                         if alive[nb[0]] and not elim[nb[0]]]
                if len(nodes) == 1 and side == 1 and len(cands) > 1:
                    cands = cands[1:]       # single-slot path, two junctions
                elif len(nodes) == 1 and side == 1 and len(cands) == 1 \
                        and juncs[0] is not None:
                    cands = []              # single junction already used
                if cands:
                    nb = cands[0]
                    pk[side] = nb[1]
                    pi[side] = nb[2]
                    # want B[j, s] = K[junction, slot]; adj entry of endn
                    # has flip=False when stored is (endn -> nbr) =
                    # (slot -> junction) -> needs transpose -> att_flip True
                    pf[side] = not nb[3]
                    juncs[side] = nb[0]
                    pending.append((level_idx, p, side, nb[0]))
            att_kind.append(pk)
            att_id.append(pi)
            att_flip.append(pf)

            # fill edge between the two junctions
            if juncs[0] is not None and juncs[1] is not None:
                fid = n_fill
                n_fill += 1
                fill_out.append(fid)
                # stored orientation (jl -> jr)
                adj[juncs[0]].append([juncs[1], KIND_FILL, fid, False])
                adj[juncs[1]].append([juncs[0], KIND_FILL, fid, True])
                fill_a.append(juncs[0])
                fill_b.append(juncs[1])
            else:
                fill_out.append(-1)

        for seed in np.nonzero(elim)[0]:
            if visited[seed] or not elim[seed]:
                continue
            visited[seed] = True
            back = walk(seed, -1)
            fwd = walk(seed, back[0] if back else -1)
            nodes_full = back[::-1] + [seed] + fwd
            if max_path_len and len(nodes_full) > max_path_len:
                # demote every (L+1)-th node to the next level: it becomes
                # the junction both neighboring chunks attach to, and the
                # chunks' fill edges chain the demoted nodes together —
                # ordinary two-level cyclic reduction
                chunks = []
                i = 0
                while i < len(nodes_full):
                    chunks.append(nodes_full[i:i + max_path_len])
                    if i + max_path_len < len(nodes_full):
                        elim[nodes_full[i + max_path_len]] = False
                    i += max_path_len + 1
            else:
                chunks = [nodes_full]
            for nodes in chunks:
                _emit_path(nodes)

        levels.append(dict(
            slots=np.asarray(slots, np.int32),
            path_start=np.asarray(path_start, bool),
            left_kind=np.asarray(lkind, np.int8),
            left_id=np.asarray(lid, np.int32),
            left_flip=np.asarray(lflip, bool),
            first_pos=np.asarray(first_pos, np.int32),
            last_pos=np.asarray(last_pos, np.int32),
            att_kind=np.asarray(att_kind, np.int8).reshape(-1, 2),
            att_id=np.asarray(att_id, np.int32).reshape(-1, 2),
            att_flip=np.asarray(att_flip, bool).reshape(-1, 2),
            fill_out=np.asarray(fill_out, np.int32),
        ))
        alive = alive & ~elim
        level_idx += 1

    # resolve pending junction targets
    lv_att_level = [np.zeros((len(lv["first_pos"]), 2), np.int32)
                    for lv in levels]
    lv_att_pos = [np.zeros((len(lv["first_pos"]), 2), np.int32)
                  for lv in levels]
    for (li, p, side, jnode) in pending:
        lv_att_level[li][p, side] = node_level[jnode]
        lv_att_pos[li][p, side] = node_pos[jnode]

    lvls = tuple(
        TreeLevel(att_level=lv_att_level[i], att_pos=lv_att_pos[i], **lv)
        for i, lv in enumerate(levels))
    return TreeSchedule(conn=np.asarray(conn, np.int32),
                        tree_edge=np.asarray(tree_edge, bool),
                        free=free, levels=lvls, n_fill=n_fill)


def element_k3(geom_n: np.ndarray, k_ax: np.ndarray, k_bd: np.ndarray
               ) -> np.ndarray:
    """(E,3,3) element coupling stiffness k = kax n n^T + kbd (I - n n^T)
    (reference src/fea_solver.py:30-68 block structure).

    Written as (kax-kbd) n n^T + kbd I via einsum: the naive
    (E,3,1)*(E,1,3) broadcast formulation hits a ~100x-slower numpy
    path (measured 23 s vs 0.2 s at 1e6 elements)."""
    out = np.einsum("ei,ej->eij", geom_n, geom_n)
    out *= (k_ax - k_bd)[:, None, None]
    out[:, 0, 0] += k_bd
    out[:, 1, 1] += k_bd
    out[:, 2, 2] += k_bd
    return out
