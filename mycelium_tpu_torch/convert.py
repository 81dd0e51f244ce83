"""Carry a model and a factorization across from the JAX package.

``jax_model_arrays``/``jax_factor_arrays`` flatten the reference's
``FeaModel``/``TreeFactor`` into ``{name: numpy array}`` (they only read
attributes and call ``np.asarray``; this module does not import jax).
``model_from_jax``/``factor_from_jax`` build the port's containers from
such a dict, so each stage of the two packages can be compared on
identical inputs apart from the host-side plan construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .fea.chain import ChainPlan, jump_csr
from .fea.elements import ElementGeometry
from .fea.model import DTYPES, FeaModel
from .fea.tree_factor import (FastFactorData, FastMeta, TreeFactor,
                              TreeMeta, TreePlan)

_MODEL_FIELDS = ("coords", "conn", "incident", "sign", "top_nodes",
                 "bot_nodes", "free_nodes")
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
        jump_ent=i(jent))
    meta = TreeMeta(
        level_offsets=tuple(int(x) for x in a["tree.meta.level_offsets"]),
        path_offsets=tuple(int(x) for x in a["tree.meta.path_offsets"]),
        level_steps=tuple(int(x) for x in a["tree.meta.level_steps"]),
        k_scale=float(a["tree.meta.k_scale"]),
        n_pcr=int(a["tree.meta.n_pcr"]))
    flags = ("tree_edge", "left_fill_flip", "att_flip", "has_fill")
    tree = TreePlan(meta=meta, **{
        k: (b(a[f"tree.{k}"]) if k in flags else
            f(a[f"tree.{k}"]) if k == "k3" else i(a[f"tree.{k}"]))
        for k in _TREE_FIELDS})
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
    return FeaModel(
        coords=f(a["coords"]), conn=i(a["conn"]),
        geom=ElementGeometry(**{k: f(a[f"geom.{k}"]) for k in _GEOM_FIELDS}),
        incident=i(a["incident"]), sign=f(a["sign"]),
        top_nodes=b(a["top_nodes"]),
        bot_nodes=b(a["bot_nodes"]), free_nodes=b(a["free_nodes"]),
        chain=chain, tree=tree, tree_fast=tree_fast)


def _halo_rows(steps: int) -> int:
    # mycelium_tpu/fea/pallas_factor.py::halo_rows (packed-layout padding)
    halo_pos = max((1 << steps) - 1, 1)
    return -(-(-(-halo_pos // 128)) // 8) * 8


def jax_factor_arrays(factor, meta) -> dict:
    """Flatten a reference TreeFactor to numpy: per-level coefficients
    ``alphas.{l}``/``betas.{l}`` (unpacked from the Pallas layout where a
    level was factored by the TPU kernel), ``dinv``, ``att_b``, ``sinv``."""
    out = {"dinv": np.asarray(factor.dinv), "att_b": np.asarray(factor.att_b)}
    if factor.sinv is not None:
        out["sinv"] = np.asarray(factor.sinv)
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
        sinv=f(arrays["sinv"]) if "sinv" in arrays else None)
