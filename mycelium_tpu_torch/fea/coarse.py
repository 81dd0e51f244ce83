"""The cluster coarse correction: a Galerkin coarse space over runs of
consecutive chain positions (port of ``mycelium_tpu/fea/pallas_cg.py``:
``plan_nb``, ``_ramp_weight``, ``coarse_cluster_blocks``,
``_coarse_matrix_chain`` and ``_coarse_inverse``; and of
``mycelium_tpu/fea/solve.py``: ``coarse_chain_apply`` and
``_coarse_chain_fn``). The reference computes it with XLA outside its
Pallas kernels; in the port the cg + coarse route computes the coarse
matrix and its inverse inside K5's launch (``kernels/csrc/chain_cg.cu``),
and the functions here are its plain version (``coarse_matrix``,
``coarse_normalize``, ``gauss_jordan``) and what the other routes use.

A cluster is ``kblk`` blocks of 128 consecutive chain positions; the coarse
space per cluster and component is a constant (and, with the 'linear'
basis, an in-cluster ramp). Coarse DOF index = f·3·NBC + k·NBC + cluster
with f in {const, ramp}, NBC = ceil(NB/kblk). ``kblk`` comes from
``coarse_cluster_blocks`` on every route, the whole-solve kernel's too.

Differences from the reference, each deliberate:
- each entry of the coarse matrix is a float64 sum over a per-model list
  of contributions in one fixed order (``CoarsePlan``), rounded once: no
  float atomics, so the card and the CPU give the same bits; the MXU Xᵀ·X
  form and its ``COARSE_MXU_CAP`` gate are TPU layout choices;
- everything is computed in the model's dtype (the reference assembles in
  float32 whatever the dtype); its float32 constants (``reg``, the 1e-5
  shift) are kept as float32 values;
- ``coarse_chain_apply`` works on (3, N) component planes, the port's
  chain layout, instead of (N, 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 128                 # chain positions per cluster block
REG32 = float(np.float32(1e-5))     # the reference's float32 shift


def plan_nb(n_nodes: int) -> int:
    """Blocks per plane, always leaving >= 1 padding position."""
    return n_nodes // BLOCK + 1


def ramp_weight(pos_in_cluster, width: int, dtype):
    """Normalized linear coordinate within a width-position cluster, in
    [-1, 1]."""
    return (pos_in_cluster.to(dtype) - (width - 1) / 2) / (width / 2)


def n_basis(cfg) -> int:
    return 2 if cfg.coarse_basis == "linear" else 1


def coarse_cluster_blocks(nb: int, cfg) -> int:
    """128-position blocks per cluster: the smallest k that keeps the
    dense coarse dimension n_basis·3·ceil(nb/k) under cfg.coarse_max_dim.
    Every consumer of ``coarse_inverse`` restricts and prolongs with the
    same k."""
    nbas = n_basis(cfg)
    cap = max(int(cfg.coarse_max_dim), 3 * nbas)
    return -(-(3 * nbas * nb) // cap)


@dataclass(frozen=True)
class CoarsePlan:
    """Which (row cluster, column cluster) block of the coarse Galerkin
    matrix each chain edge, jump edge and reg diagonal feeds: a fact of the
    mesh and the cluster layout, built once on the host
    (``build_coarse_plan``). Per block, its contributions in one fixed
    order (chain edges by slot, then jump edges by row, each with its
    (row end, column end) roles aa, ba, ab, bb; then the reg diagonal by
    position). A contribution is the code source·16 + kind: kinds 0-3 a
    chain edge (source: its slot, ends q and q + 1), 4-7 a jump edge
    (source: its row, ends ja and jb), bit 0 the row's end b, bit 1 the
    column's end b; kind 8 the reg diagonal at position source. Only the
    masks change from solve to solve; every entry is summed in float64 in
    this order and rounded once, by K5's set-up on the card and by
    ``coarse_matrix`` elsewhere."""
    nbc: int
    width: int
    nbas: int
    blk_row: torch.Tensor       # (nblk,) int32 row cluster
    blk_col: torch.Tensor       # (nblk,) int32 column cluster
    blk_ptr: torch.Tensor       # (nblk + 1,) int32
    blk_ent: torch.Tensor       # (M,) int32 codes
    blk_map: torch.Tensor       # (nbc²,) int32 block of a cluster pair, -1

    @property
    def nc(self) -> int:
        return 3 * self.nbas * self.nbc


KIND_JUMP = 4
KIND_REG = 8


def build_coarse_plan(cplan, n_elems: int, nbc: int, width: int,
                      nbas: int) -> CoarsePlan:
    """The contribution lists of a chain plan's coarse matrix (host numpy
    from the plan's tensors, moved to the plan's device)."""
    dev = cplan.perm.device
    n = cplan.perm.shape[0]
    chain_elem = cplan.chain_elem.cpu().numpy()
    ja, jb = cplan.ja.cpu().numpy(), cplan.jb.cpu().numpy()
    slots = np.nonzero(chain_elem < n_elems)[0]
    slots = slots[slots + 1 < n]
    jumps = np.nonzero((ja < n) & (jb < n))[0]
    row_cl, col_cl, codes = [], [], []
    for kind0, src, end_a, end_b in ((0, slots, slots, slots + 1),
                                     (KIND_JUMP, jumps, ja[jumps],
                                      jb[jumps])):
        for role in range(4):
            rpos = end_b if role & 1 else end_a
            cpos = end_b if role & 2 else end_a
            row_cl.append(rpos // width)
            col_cl.append(cpos // width)
            codes.append(src * 16 + kind0 + role)
    pos = np.arange(n)
    row_cl.append(pos // width)
    col_cl.append(pos // width)
    codes.append(pos * 16 + KIND_REG)
    # contribution order: chain, jump, reg; within a kind by source, then
    # role
    rc = np.stack([np.concatenate(x) for x in (row_cl, col_cl, codes)])
    kinds = rc[2] & 15
    group = np.where(kinds >= KIND_REG, 2, np.where(kinds >= KIND_JUMP, 1, 0))
    order = np.lexsort((kinds, rc[2] >> 4, group, rc[1], rc[0]))
    rc = rc[:, order]
    key = rc[0] * nbc + rc[1]
    blocks, counts = np.unique(key, return_counts=True)
    ptr = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    bmap = np.full(nbc * nbc, -1, np.int64)
    bmap[blocks] = np.arange(len(blocks))
    if rc[2].max(initial=0) >= 2 ** 31:
        raise ValueError("coarse plan: a source does not fit 27 bits")

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
    return CoarsePlan(nbc=nbc, width=width, nbas=nbas,
                      blk_row=i32(blocks // nbc), blk_col=i32(blocks % nbc),
                      blk_ptr=i32(ptr), blk_ent=i32(rc[2]), blk_map=i32(bmap))


class CoarsePlans:
    """The coarse plans of one model, by cluster layout (nbc, width, nbas):
    each built once on the host (``build_coarse_plan``) at its first use
    and kept. The model carries it (``fea/model.py::with_kernels``); the
    routes that assemble the coarse matrix in PyTorch operations and K5's
    launch take their plans from it."""

    def __init__(self, cplan, n_elems: int):
        self.cplan = cplan
        self.n_elems = int(n_elems)
        self._plans = {}

    def get(self, nbc: int, width: int, nbas: int) -> CoarsePlan:
        key = (nbc, width, nbas)
        if key not in self._plans:
            self._plans[key] = build_coarse_plan(self.cplan, self.n_elems,
                                                 *key)
        return self._plans[key]

    def on(self, device) -> "CoarsePlans":
        """The same plans, those built so far included, with their tensors
        on ``device``."""
        from ..devices import moved
        out = CoarsePlans(moved(self.cplan, device), self.n_elems)
        out._plans = {k: moved(v, device) for k, v in self._plans.items()}
        return out


def coarse_matrix(plan: CoarsePlan, cplan, active, free_chain, reg: float,
                  dtype):
    """The (nc, nc) coarse Galerkin matrix of the free-masked operator
    P·K·P + reg·P over the plan's clusters, in the order and precision of
    K5's set-up (``csrc/chain_cg.cu::coarse_entry``): each entry the
    float64 sum, in the plan's order, of the exact float64 products
    w_row·w_col·k3 (w the basis weight at an end: 0 off the free mask, 1 or
    the in-cluster ramp), rounded to ``dtype`` once. ``active`` (E,) bool
    by element, ``free_chain`` (N,) bool in chain order. On the CPU the
    entries add one term after another (a sequential ``index_add_``)."""
    f64 = torch.float64
    dev = cplan.perm.device
    n = cplan.perm.shape[0]
    width, nbc, nbas = plan.width, plan.nbc, plan.nbas
    d = 3 * nbas
    codes = plan.blk_ent.to(torch.int64)
    src, kind = codes >> 4, codes & 15
    is_jump = (kind >= KIND_JUMP) & (kind < KIND_REG)
    is_reg = kind == KIND_REG
    row_b, col_b = (kind & 1) == 1, (kind & 2) == 2
    jsrc = torch.where(is_jump, src, 0)
    csrc = torch.where(is_jump | is_reg, 0, src)
    ea = torch.where(is_jump, cplan.ja[jsrc], torch.where(is_reg, src, csrc))
    eb = torch.where(is_jump, cplan.jb[jsrc], torch.where(is_reg, src,
                                                          csrc + 1))
    pr = torch.where(row_b & ~is_reg, eb, ea)
    pc = torch.where(col_b & ~is_reg, eb, ea)
    act_pad = torch.cat([active.to(torch.bool),
                         active.new_zeros((1,), dtype=torch.bool)])
    n_elems = active.shape[0]
    m = torch.where(is_jump,
                    act_pad[cplan.jump_elem.clamp(max=n_elems)[jsrc]],
                    act_pad[cplan.chain_elem.clamp(max=n_elems)[csrc]])
    nvec = torch.where(is_jump[None, :], cplan.jump_n[:, jsrc],
                       cplan.chain_n[:, csrc]).to(f64)
    kax = torch.where(is_jump, cplan.jump_kax[jsrc],
                      cplan.chain_kax[csrc]).to(f64)
    kbd = torch.where(is_jump, cplan.jump_kbd[jsrc],
                      cplan.chain_kbd[csrc]).to(f64)
    sign = torch.where(row_b == col_b, 1.0, -1.0).to(f64)
    ramp = ramp_weight(torch.arange(n, device=dev) % width, width,
                       cplan.chain_kbd.dtype).to(f64)

    def weights(p):
        fr = free_chain[p]
        return [torch.where(fr, 1.0, 0.0).to(f64)] + (
            [torch.where(fr, ramp[p], 0.0)] if nbas == 2 else [])

    wr, wc = weights(pr), weights(pc)
    reg64 = float(np.float32(reg))
    terms = torch.empty((codes.shape[0], d, d), dtype=f64, device=dev)
    for kc in range(3):
        for kc2 in range(3):
            k3 = nvec[kc] * nvec[kc2]
            k3 = k3 * (kax - kbd)
            if kc == kc2:
                k3 = k3 + kbd
            k3 = k3 * m.to(f64)
            v = torch.where(is_reg, reg64 if kc == kc2 else 0.0, sign * k3)
            for fa in range(nbas):
                for fb in range(nbas):
                    terms[:, 3 * fa + kc, 3 * fb + kc2] = (wr[fa] * wc[fb]) * v
    counts = plan.blk_ptr[1:] - plan.blk_ptr[:-1]
    blk = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                  counts.to(torch.int64))
    target = (blk[:, None] * (d * d)
              + torch.arange(d * d, device=dev)[None, :]).reshape(-1)
    sums = torch.zeros(counts.shape[0] * d * d, dtype=f64, device=dev)
    sums.index_add_(0, target, terms.reshape(-1))
    sums = sums.reshape(-1, d, d)
    nc = plan.nc
    fk = torch.arange(d, device=dev)
    base = (fk // 3) * (3 * nbc) + (fk % 3) * nbc
    rows = base[None, :, None] + plan.blk_row.to(torch.int64)[:, None, None]
    cols = base[None, None, :] + plan.blk_col.to(torch.int64)[:, None, None]
    out = torch.zeros(nc * nc, dtype=f64, device=dev)
    out[(rows * nc + cols).reshape(-1)] = sums.reshape(-1)
    return out.reshape(nc, nc).to(dtype)


def coarse_normalize(a):
    """(s, an): the scaling 1/sqrt(diag) (1 where the diagonal is not
    positive) and the normalised matrix s·a·s + 1e-5·I, plus 1 on the
    diagonal of a row with no stiffness; K5's set-up's order."""
    nc = a.shape[0]
    d = torch.diagonal(a)
    # rsqrt: on the CPU two correctly rounded operations, as 1/sqrtf on the
    # card (torch.sqrt itself is not correctly rounded there)
    s = torch.where(d > 0, torch.rsqrt(d.clamp(min=1e-30)), 1.0)
    eye = torch.eye(nc, dtype=a.dtype, device=a.device)
    an = s[:, None] * a * s[None, :] + REG32 * eye \
        + torch.diag(torch.where(d > 0, 0.0, 1.0).to(a.dtype))
    return s, an


def gauss_jordan(an):
    """The inverse of a symmetric positive definite matrix by Gauss-Jordan
    elimination without pivoting, in its dtype: pivot k scales row k by
    p = 1/a_kk and subtracts a_ik·(a_kj·p) from every other row, column k
    becoming -a_ik·p. K5's set-up runs the same operations one pivot a
    phase (``csrc/chain_cg.cu::gauss_jordan_step``)."""
    g = an.clone()
    for k in range(g.shape[0]):
        p = 1.0 / g[k, k]
        rk = g[k] * p
        f = g[:, k].clone()
        nxt = g - f[:, None] * rk[None, :]
        nxt[:, k] = -(f * p)
        nxt[k] = rk
        nxt[k, k] = p
        g = nxt
    return g


def coarse_matrix_chain(model, active, free, cfg, nb: int, kblk: int = 1):
    """The coarse Galerkin matrix of the free-masked operator P·K·P + reg·P
    (no (I−P) identity: the restriction is free-masked) over clusters of
    ``kblk`` blocks, in the model's dtype: ``coarse_matrix`` on the
    model's plan for that layout."""
    width = kblk * BLOCK
    plan = model.coarse_plans.get(-(-nb // kblk), width, n_basis(cfg))
    return coarse_matrix(plan, model.chain, active,
                         free[model.chain.perm], cfg.reg, model.dtype)


def coarse_inverse(model, active, free, cfg, nb: int, kblk: int = 1):
    """The dense inverse of the coarse matrix, symmetrically normalized to
    unit diagonal with a 1e-5 shift (rows with no stiffness get 1): the
    library's inverse, for the routes that run in PyTorch operations (K5
    inverts on the card in its set-up)."""
    s, an = coarse_normalize(coarse_matrix_chain(model, active, free, cfg,
                                                 nb, kblk))
    # contiguous: the inverse comes back column-major on the card
    return (s[:, None] * torch.linalg.inv(an) * s[None, :]).contiguous()


def coarse_chain_apply(ainv, free_p, r, n: int, nbc: int, width: int,
                       rampw, use_ramp: bool, scale=None):
    """One coarse correction on chain-ordered (3, N) residual planes:
    restriction is a reshape-sum over width-position clusters,
    prolongation a broadcast. ``free_p`` is the (N,) free mask in chain
    order in r's dtype, ``rampw`` the (nbc·width,) in-cluster ramp.
    ``scale``: ``ainv`` is the normalised inverse and the product is
    scale·ainv·(scale·rc), as K5 reads it.

    The cluster sums and the rows of ainv·rc add in float64 (products of
    the working dtype are exact there) and round once to r's dtype, as
    the whole-solve kernel K5 does; in float64 this is the plain sum."""
    f64 = torch.float64
    rf = r * free_p
    rcl = F.pad(rf, (0, nbc * width - n)).reshape(3, nbc, width)
    parts = [rcl.to(f64).sum(2).reshape(-1)]      # comp·nbc + cluster
    rw = rampw.reshape(nbc, width)
    if use_ramp:
        parts.append((rcl * rw).to(f64).sum(2).reshape(-1))
    rc = torch.cat(parts).to(r.dtype)
    if scale is not None:
        rc = scale * rc
    zc = (ainv.to(f64) @ rc.to(f64)).to(r.dtype)
    if scale is not None:
        zc = scale * zc
    zn = zc[:3 * nbc].reshape(3, nbc, 1).expand(3, nbc, width)
    if use_ramp:
        zn = zn + zc[3 * nbc:].reshape(3, nbc, 1) * rw
    return zn.reshape(3, nbc * width)[:, :n] * free_p


@dataclass(frozen=True)
class CoarseSpace:
    """What a solve needs of the coarse correction: the dense inverse and
    the cluster layout."""
    ainv: torch.Tensor          # (nc, nc)
    free_p: torch.Tensor        # (N,) free mask in chain order
    rampw: torch.Tensor         # (nbc·width,)
    nbc: int
    width: int
    use_ramp: bool

    def apply(self, r):
        return coarse_chain_apply(self.ainv, self.free_p, r, r.shape[1],
                                  self.nbc, self.width, self.rampw,
                                  self.use_ramp)


def cluster_layout(n_nodes: int, cfg):
    """(nb, kblk, nbc, width) of the coarse space of an n_nodes mesh."""
    nb = plan_nb(n_nodes)
    kblk = coarse_cluster_blocks(nb, cfg)
    return nb, kblk, -(-nb // kblk), kblk * BLOCK


def coarse_space(model, active, cfg, free, ainv=None) -> CoarseSpace:
    """The coarse correction of (active, free) on chain-ordered planes;
    ``ainv`` injects a precomputed inverse (``TreeFactor.coarse_ainv``)."""
    nb, kblk, nbc, width = cluster_layout(model.n_nodes, cfg)
    if ainv is None:
        ainv = coarse_inverse(model, active, free, cfg, nb, kblk)
    pos = torch.arange(nbc * width, device=model.device)
    return CoarseSpace(ainv=ainv, free_p=free[model.chain.perm].to(
        model.dtype), rampw=ramp_weight(pos % width, width, model.dtype),
        nbc=nbc, width=width, use_ramp=cfg.coarse_basis == "linear")
