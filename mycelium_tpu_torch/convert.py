"""Carry a model, a factorization and a growth state across from the JAX
package.

``jax_model_arrays``/``jax_factor_arrays``/``jax_growth_arrays`` flatten
the reference's ``FeaModel``/``TreeFactor``/``GrowthState`` into
``{name: numpy array}`` (they only read attributes and call
``np.asarray``; this module does not import jax).
``model_from_jax``/``factor_from_jax``/``growth_state_from_jax`` build the
port's containers from such a dict, so each stage of the two packages can
be compared on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .fea.chain import ChainPlan, jump_csr
from .fea.elements import ElementGeometry
from .fea.model import DTYPES, FeaModel, with_kernels
from .fea.tree_factor import (FastFactorData, FastMeta, TreeFactor,
                              TreeMeta, TreePlan, with_host_lists)
from .growth.neighbors import SegGrid, grid_dims
from .growth.state import DTYPES as GROWTH_DTYPES
from .growth.state import GrowthState

_MODEL_FIELDS = ("coords", "conn", "incident", "sign", "neighbor",
                 "top_nodes", "bot_nodes", "free_nodes")
_GEOM_FIELDS = ("n", "length", "k_ax", "k_bd")
_CHAIN_FIELDS = ("perm", "inv_perm", "chain_elem", "chain_n", "chain_kax",
                 "chain_kbd", "jump_elem", "jump_n", "jump_kax", "jump_kbd",
                 "ja", "jb")
_TREE_FIELDS = ("tree_edge", "k3", "slots", "left_elem", "left_fill",
                "left_fill_flip", "first_gpos", "last_gpos", "att_elem",
                "att_fill", "att_flip", "att_tgt", "has_fill", "dense_eid",
                "dense_i", "dense_j")
_META_FIELDS = ("level_offsets", "path_offsets", "level_steps", "k_scale",
                "n_pcr")
_FAST_FIELDS = ("chain_tree", "jump_tree", "left_k3", "ja", "jb")


def jax_model_arrays(model) -> dict:
    """Flatten a reference FeaModel (chain operator, tree PC) to numpy."""
    out = {k: np.asarray(getattr(model, k)) for k in _MODEL_FIELDS}
    out.update({f"geom.{k}": np.asarray(getattr(model.geom, k))
                for k in _GEOM_FIELDS})
    out.update({f"chain.{k}": np.asarray(getattr(model.chain, k))
                for k in _CHAIN_FIELDS})
    out.update({f"tree.{k}": np.asarray(getattr(model.tree, k))
                for k in _TREE_FIELDS})
    out.update({f"tree.meta.{k}": np.asarray(getattr(model.tree.meta, k))
                for k in _META_FIELDS})
    if model.tree_fast is not None:
        out.update({f"tree_fast.{k}": np.asarray(getattr(model.tree_fast, k))
                    for k in _FAST_FIELDS})
        fm = model.tree_fast.meta
        out["tree_fast.meta.level_left_fill"] = np.asarray(
            fm.level_left_fill, bool)
        out["tree_fast.meta.left_is_chain_shift"] = np.asarray(
            fm.left_is_chain_shift)
    return out


def model_from_jax(arrays: dict, cfg, device) -> FeaModel:
    """The port's FeaModel from ``jax_model_arrays`` output."""
    dtype = DTYPES[cfg.dtype]
    device = torch.device(device)

    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def i(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.tensor(np.asarray(a, bool), device=device)

    a = arrays
    n = a["coords"].shape[0]
    n_jumps = int(np.sum(a["chain.jump_elem"] < a["conn"].shape[0]))
    jptr, jent = jump_csr(a["chain.ja"], a["chain.jb"], n_jumps, n)
    chain = ChainPlan(
        perm=i(a["chain.perm"]), inv_perm=i(a["chain.inv_perm"]),
        chain_elem=i(a["chain.chain_elem"]),
        chain_n=f(a["chain.chain_n"].T), chain_kax=f(a["chain.chain_kax"]),
        chain_kbd=f(a["chain.chain_kbd"]),
        jump_elem=i(a["chain.jump_elem"]), jump_n=f(a["chain.jump_n"].T),
        jump_kax=f(a["chain.jump_kax"]), jump_kbd=f(a["chain.jump_kbd"]),
        ja=i(a["chain.ja"]), jb=i(a["chain.jb"]), jump_ptr=i(jptr),
        jump_ent=i(jent)).with_kernel_tables()
    meta = TreeMeta(
        level_offsets=tuple(int(x) for x in a["tree.meta.level_offsets"]),
        path_offsets=tuple(int(x) for x in a["tree.meta.path_offsets"]),
        level_steps=tuple(int(x) for x in a["tree.meta.level_steps"]),
        k_scale=float(a["tree.meta.k_scale"]),
        n_pcr=int(a["tree.meta.n_pcr"]))
    flags = ("tree_edge", "left_fill_flip", "att_flip", "has_fill")
    tree = with_host_lists(TreePlan(meta=meta, **{
        k: (b(a[f"tree.{k}"]) if k in flags else
            f(a[f"tree.{k}"]) if k == "k3" else i(a[f"tree.{k}"]))
        for k in _TREE_FIELDS}))
    tree_fast = None
    if "tree_fast.left_k3" in a:
        tree_fast = FastFactorData(
            chain_tree=b(a["tree_fast.chain_tree"]),
            jump_tree=b(a["tree_fast.jump_tree"]),
            left_k3=f(a["tree_fast.left_k3"]), ja=i(a["tree_fast.ja"]),
            jb=i(a["tree_fast.jb"]),
            meta=FastMeta(
                level_left_fill=tuple(
                    bool(x) for x in a["tree_fast.meta.level_left_fill"]),
                left_is_chain_shift=bool(
                    a["tree_fast.meta.left_is_chain_shift"])))
    return with_kernels(FeaModel(
        coords=f(a["coords"]), conn=i(a["conn"]),
        geom=ElementGeometry(**{k: f(a[f"geom.{k}"]) for k in _GEOM_FIELDS}),
        incident=i(a["incident"]), sign=f(a["sign"]),
        neighbor=i(a["neighbor"]),
        top_nodes=b(a["top_nodes"]),
        bot_nodes=b(a["bot_nodes"]), free_nodes=b(a["free_nodes"]),
        chain=chain, tree=tree, tree_fast=tree_fast))


def _halo_rows(steps: int) -> int:
    # mycelium_tpu/fea/pallas_factor.py::halo_rows (packed-layout padding)
    halo_pos = max((1 << steps) - 1, 1)
    return -(-(-(-halo_pos // 128)) // 8) * 8


def jax_factor_arrays(factor, meta) -> dict:
    """Flatten a reference TreeFactor to numpy: per-level coefficients
    ``alphas.{l}``/``betas.{l}`` (unpacked from the Pallas layout where a
    level was factored by the TPU kernel), ``dinv``, ``att_b``, ``sinv``,
    and ``coarse_ainv`` when the factor carries the coarse inverse."""
    out = {"dinv": np.asarray(factor.dinv), "att_b": np.asarray(factor.att_b)}
    if factor.sinv is not None:
        out["sinv"] = np.asarray(factor.sinv)
    if getattr(factor, "coarse_ainv", None) is not None:
        out["coarse_ainv"] = np.asarray(factor.coarse_ainv)
    packed = getattr(factor, "packed", ())
    for li, al in enumerate(factor.alphas):
        be = factor.betas[li]
        if al is None:
            steps = meta.level_steps[li]
            S = meta.level_offsets[li + 1] - meta.level_offsets[li]
            h = _halo_rows(steps)
            al_p, be_p = (np.asarray(x) for x in packed[li][:2])
            al = al_p[:, :, h:-h].reshape(steps, 9, -1)[:, :, :S]
            be = be_p[:, :, h:-h].reshape(steps, 9, -1)[:, :, :S]
        out[f"alphas.{li}"] = np.asarray(al)
        out[f"betas.{li}"] = np.asarray(be)
    return out


def factor_from_jax(arrays: dict, tree: TreePlan, dtype, device) -> TreeFactor:
    """The port's TreeFactor from ``jax_factor_arrays`` output."""
    def f(x):
        return torch.tensor(np.ascontiguousarray(x, np.float64),
                            dtype=dtype, device=device)
    meta = tree.meta
    L = len([k for k in arrays if k.startswith("alphas.")])
    off = meta.level_offsets
    return TreeFactor(
        alphas=tuple(f(arrays[f"alphas.{li}"]) for li in range(L)),
        betas=tuple(f(arrays[f"betas.{li}"]) for li in range(L)),
        dinvs=tuple(f(arrays["dinv"][:, off[li]:off[li + 1]])
                    for li in range(L)),
        att_b=f(arrays["att_b"]),
        sinv=f(arrays["sinv"]) if "sinv" in arrays else None,
        coarse_ainv=(f(arrays["coarse_ainv"]) if "coarse_ainv" in arrays
                     else None))


_GROWTH_FIELDS = ("start", "end", "theta", "phi", "sub", "state", "prev",
                  "hypha", "tip", "n_seg", "n_hyp", "env_e", "step",
                  "overflow")
_GRID_FIELDS = ("ids", "r_ab2", "count", "occ", "n_seen")


def jax_growth_arrays(state) -> dict:
    """Flatten a reference GrowthState (and its SegGrid, if it carries
    one) to numpy."""
    out = {k: np.asarray(getattr(state, k)) for k in _GROWTH_FIELDS}
    grid = getattr(state, "grid", None)
    if grid is not None:
        out.update({f"grid.{k}": np.asarray(getattr(grid, k))
                    for k in _GRID_FIELDS})
        for k in range(3):
            out[f"grid.a{k}"] = np.asarray(grid.a[k])
            out[f"grid.ab{k}"] = np.asarray(grid.ab[k])
    return out


def growth_state_from_jax(arrays: dict, cfg, device) -> GrowthState:
    """The port's GrowthState from ``jax_growth_arrays`` output. The grid
    changes layout: the reference stores plane p = rank (2D) as
    (p, cx, cy), flat index rank·M + cell; the port stores cell-major,
    cell·C + rank. A state without a grid gets none (``ensure_grid``
    attaches an empty one; the next step inserts the backlog)."""
    dtype = GROWTH_DTYPES[cfg.dtype]
    device = torch.device(device)
    a = arrays

    def f(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                            device=device)

    def i(x, dt=torch.int32):
        return torch.tensor(np.asarray(x, np.int64), dtype=dt,
                            device=device)

    grid = None
    if "grid.ids" in a:
        g, gz = grid_dims(cfg)
        if gz != 1:
            raise NotImplementedError("3D growth grids: ROADMAP queue A "
                                      "item 13")
        M, C = g * g, cfg.max_per_cell

        def cell_major(x):
            return np.asarray(x).reshape(C, M).T.reshape(-1)

        geo = np.stack([cell_major(a[f"grid.a{k}"]) for k in range(3)]
                       + [cell_major(a[f"grid.ab{k}"]) for k in range(3)]
                       + [cell_major(a["grid.r_ab2"]),
                          np.zeros(M * C)], axis=1)
        grid = SegGrid(ids=i(cell_major(a["grid.ids"])), geo=f(geo),
                       count=i(a["grid.count"]),
                       n_seen=int(a["grid.n_seen"]))
    return GrowthState(
        start=f(a["start"]), end=f(a["end"]), theta=f(a["theta"]),
        phi=f(a["phi"]), sub=f(a["sub"]), state=i(a["state"], torch.int8),
        prev=i(a["prev"]), hypha=i(a["hypha"]), tip=i(a["tip"]),
        n_seg=int(a["n_seg"]), n_hyp=int(a["n_hyp"]), env_e=f(a["env_e"]),
        step=int(a["step"]),
        overflow=torch.tensor(bool(a["overflow"]), device=device),
        grid=grid)
