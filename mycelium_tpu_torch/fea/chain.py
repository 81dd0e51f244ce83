"""Chain-ordered sparse operator (port of ``mycelium_tpu/fea/chain.py``).

Nodes are permuted so that most elements join consecutive positions
(p, p+1): the "chain" part of K·u is then a 3-point stencil, and the few
remaining "jump" elements (branch points, anastomoses) are a gather plus
a scatter. Host side: ``greedy_path_cover`` and ``build_chain_plan``
(numpy, array-equal to the reference's tables; the TPU one-hot jump
tables are not built). Device side: ``ChainPlan``, ``chain_apply`` and
``plan_active_masks_bool``. The per-iteration operator is the K1 kernel
(``kernels/chain_matvec.py``); its plain version is the gather/scatter
form of the reference's ``chain_apply``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mycelium_tpu.native import meshio_native

from ..kernels.chain_matvec import chain_matvec


def greedy_path_cover(conn: np.ndarray, n_nodes: int) -> np.ndarray:
    """Order nodes along a greedy path cover of the element graph.

    Walks unvisited nodes depth-first but only ever continues along ONE
    unvisited neighbor (a path, not a tree), starting new paths at
    low-degree nodes first (chain tips). Returns perm: position -> node.
    Uses the native library (same semantics) when it is available."""
    native = meshio_native.path_cover(conn, n_nodes)
    if native is not None:
        return native
    n_elems = conn.shape[0]
    deg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(deg, conn[:, 0], 1)
    np.add.at(deg, conn[:, 1], 1)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    adj = np.empty(2 * n_elems, dtype=np.int64)
    cursor = indptr[:-1].copy()
    for a, b in ((0, 1), (1, 0)):
        src = conn[:, a].astype(np.int64)
        dst = conn[:, b].astype(np.int64)
        order = np.argsort(src, kind="stable")
        pos = cursor[src[order]] + (
            np.arange(len(order)) - np.searchsorted(src[order], src[order]))
        adj[pos] = dst[order]
        cursor += np.bincount(src, minlength=n_nodes)

    visited = np.zeros(n_nodes, dtype=bool)
    perm = np.empty(n_nodes, dtype=np.int64)
    out = 0
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        cur = s
        while True:
            visited[cur] = True
            perm[out] = cur
            out += 1
            nxt = -1
            for k in range(indptr[cur], indptr[cur + 1]):
                if not visited[adj[k]]:
                    nxt = adj[k]
                    break
            if nxt < 0:
                break
            cur = nxt
    if out != n_nodes:
        raise RuntimeError("path cover did not visit every node")
    return perm


def jump_csr(ja: np.ndarray, jb: np.ndarray, n_jumps: int, n_nodes: int):
    """Per-node jump incidence for the kernel's deterministic scatter:
    node p's entries are jump_ent[jump_ptr[p]:jump_ptr[p+1]], each
    2*j + side (side 0: p is ja[j], +f; side 1: p is jb[j], -f)."""
    nodes = np.concatenate([ja[:n_jumps], jb[:n_jumps]]).astype(np.int64)
    ent = np.concatenate([2 * np.arange(n_jumps), 2 * np.arange(n_jumps) + 1])
    order = np.argsort(nodes, kind="stable")
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(nodes, minlength=n_nodes), out=ptr[1:])
    return ptr, ent[order].astype(np.int64)


def build_chain_plan(coords: np.ndarray, conn: np.ndarray,
                     geom_n: np.ndarray, k_ax: np.ndarray, k_bd: np.ndarray,
                     perm: np.ndarray | None = None) -> dict:
    """Classify elements as chain (consecutive after permutation) or jump.
    Inputs are host numpy in ORIGINAL node numbering; returns the host
    tables (reference names and layouts, jumps padded to a multiple of 8
    with the sentinel N) plus the jump CSR."""
    n_nodes = coords.shape[0]
    n_elems = conn.shape[0]
    if perm is None:
        perm = greedy_path_cover(conn, n_nodes)
    perm = np.asarray(perm, np.int64)
    if perm.shape != (n_nodes,):
        raise ValueError(f"perm has shape {perm.shape}, want ({n_nodes},)")
    inv = np.empty(n_nodes, dtype=np.int64)
    inv[perm] = np.arange(n_nodes)

    p1 = inv[conn[:, 0]]
    p2 = inv[conn[:, 1]]
    lo = np.minimum(p1, p2)
    is_chain = np.abs(p1 - p2) == 1
    # at most one element may claim a chain slot; the first one wins
    slot_owner = np.full(n_nodes, n_elems, dtype=np.int64)
    for e in np.nonzero(is_chain)[0]:
        if slot_owner[lo[e]] == n_elems:
            slot_owner[lo[e]] = e
        else:
            is_chain[e] = False
    jump_ids = np.nonzero(~is_chain)[0]

    # chain arrays, sign-adjusted so n points from position i to i+1
    chain_n = np.zeros((n_nodes, 3))
    chain_kax = np.zeros(n_nodes)
    chain_kbd = np.zeros(n_nodes)
    have = slot_owner < n_elems
    e_own = slot_owner[have]
    sgn = np.where(inv[conn[e_own, 0]] < inv[conn[e_own, 1]], 1.0, -1.0)
    chain_n[have] = geom_n[e_own] * sgn[:, None]
    chain_kax[have] = k_ax[e_own]
    chain_kbd[have] = k_bd[e_own]

    J = len(jump_ids)
    Jp = max(int(np.ceil(max(J, 1) / 8)) * 8, 8)
    jn = np.zeros((Jp, 3))
    jkax = np.zeros(Jp)
    jkbd = np.zeros(Jp)
    jelem = np.full(Jp, n_elems, dtype=np.int64)
    ja = np.full(Jp, n_nodes, np.int64)
    jb = np.full(Jp, n_nodes, np.int64)
    if J:
        jn[:J] = geom_n[jump_ids]
        jkax[:J] = k_ax[jump_ids]
        jkbd[:J] = k_bd[jump_ids]
        jelem[:J] = jump_ids
        ja[:J] = inv[conn[jump_ids, 0]]
        jb[:J] = inv[conn[jump_ids, 1]]
    jump_ptr, jump_ent = jump_csr(ja, jb, J, n_nodes)
    return dict(perm=perm, inv_perm=inv, chain_elem=slot_owner,
                chain_n=chain_n, chain_kax=chain_kax, chain_kbd=chain_kbd,
                jump_elem=jelem, jump_n=jn, jump_kax=jkax, jump_kbd=jkbd,
                ja=ja, jb=jb, jump_ptr=jump_ptr, jump_ent=jump_ent)


@dataclass(frozen=True)
class ChainPlan:
    """Device tables of the chain operator. Node-indexed arrays live in
    PERMUTED space (permuted[i] = original[perm[i]]); direction tables are
    (3, ·) component planes."""
    perm: torch.Tensor          # (N,) int64 position -> original node
    inv_perm: torch.Tensor      # (N,) int64 original node -> position
    chain_elem: torch.Tensor    # (N,) int64 element of slot p (or E)
    chain_n: torch.Tensor       # (3, N) unit direction p -> p+1
    chain_kax: torch.Tensor     # (N,)
    chain_kbd: torch.Tensor     # (N,)
    jump_elem: torch.Tensor     # (Jp,) int64 (E for padding rows)
    jump_n: torch.Tensor        # (3, Jp) direction a -> b
    jump_kax: torch.Tensor      # (Jp,)
    jump_kbd: torch.Tensor      # (Jp,)
    ja: torch.Tensor            # (Jp,) int64 positions (N for padding)
    jb: torch.Tensor            # (Jp,) int64
    jump_ptr: torch.Tensor      # (N+1,) int64 per-node jump CSR
    jump_ent: torch.Tensor      # (2J,) int64 entries 2*j + side

    @staticmethod
    def from_host(host: dict, dtype, device) -> "ChainPlan":
        def f(k, transpose=False):
            a = np.asarray(host[k], np.float64)
            a = np.ascontiguousarray(a.T) if transpose else a
            return torch.as_tensor(a, dtype=dtype, device=device)

        def i(k):
            return torch.as_tensor(np.asarray(host[k], np.int64),
                                   device=device)
        return ChainPlan(
            perm=i("perm"), inv_perm=i("inv_perm"),
            chain_elem=i("chain_elem"), chain_n=f("chain_n", True),
            chain_kax=f("chain_kax"), chain_kbd=f("chain_kbd"),
            jump_elem=i("jump_elem"), jump_n=f("jump_n", True),
            jump_kax=f("jump_kax"), jump_kbd=f("jump_kbd"),
            ja=i("ja"), jb=i("jb"), jump_ptr=i("jump_ptr"),
            jump_ent=i("jump_ent"))


def plan_active_masks_bool(plan: ChainPlan, active: torch.Tensor):
    """The per-element active mask gathered into plan order: (N,) chain
    slots and (Jp,) jump rows (sentinel rows read False)."""
    act_pad = torch.cat([active.to(torch.bool),
                         active.new_zeros((1,), dtype=torch.bool)])
    return act_pad[plan.chain_elem], act_pad[plan.jump_elem]


def chain_apply(plan: ChainPlan, chain_act, jump_act, u_perm):
    """K·u in permuted space, (N, 3) -> (N, 3); the masks are in plan
    order and in u's dtype. Goes through K1 on a CUDA tensor."""
    u = u_perm.T.contiguous()
    ones = torch.ones_like(u[0])
    return chain_matvec(plan, u, ones, chain_act, jump_act, 0.0,
                        bc=False).T
