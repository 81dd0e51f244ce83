"""K2/K3's module: the plain PCR factor and apply against the reference.

float64: ``pcr_coeffs_plain``/``pcr_apply_plain`` against
``tree_jax._pcr_coeffs``/``_pcr_apply`` to 1e-12. float32: the factor with
its corner solve and the apply against the TPU kernels
(``pallas_factor.pcr_level_kernel``/``pcr_apply_planes_kernel``) run in
interpret mode with 4-row chunks, so their halo windows split the level.
The CUDA kernels are held against the plain versions on the card in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mycelium_tpu.fea.pallas_factor as pf
from mycelium_tpu.fea import tree_jax as trj
from mycelium_tpu_torch.kernels import (pcr_apply_plain, pcr_factor,
                                        pcr_factor_plain)
from mycelium_tpu_torch.kernels.pcr import pcr_coeffs_plain
from tests.torch_support import (all_levels, emulate_pcr_windows, grip_for,
                                 level0, random_forest_mesh, synthetic_mesh)
from tests.torch_support import rel_err as _rel


@pytest.mark.parametrize("seed,frac", [(11, 0.0), (12, 0.08)])
def test_plain_pcr_matches_reference_f64(seed, frac):
    D, B, fg, lg, steps = level0(seed, frac)
    al, be, dinv = pcr_coeffs_plain(D, B, steps)
    ral, rbe, rdinv = trj._pcr_coeffs(tuple(jnp.asarray(D.numpy())),
                                      tuple(jnp.asarray(B.numpy())), steps)
    assert al.shape == ral.shape and steps > 0
    assert _rel(al.numpy(), ral) < 1e-12
    assert _rel(be.numpy(), rbe) < 1e-12
    assert _rel(dinv.numpy(), np.stack(rdinv)) < 1e-12
    rng = np.random.default_rng(seed)
    for shape in ((3, D.shape[1]), (3, D.shape[1], 6)):
        r = rng.standard_normal(shape)
        x = pcr_apply_plain(al, be, dinv, torch.as_tensor(r)).numpy()
        rx = trj._pcr_apply(ral, rbe, rdinv, tuple(jnp.asarray(r)))
        assert _rel(x, np.stack(rx)) < 1e-12


@pytest.mark.parametrize("seed,frac", [(11, 0.0), (12, 0.08)])
def test_plain_pcr_matches_tpu_kernels_f32(seed, frac, monkeypatch):
    """float32 against the Pallas kernels in interpret mode. Both evaluate
    the same float32 expressions in the same order, but XLA may contract
    multiply-adds and the kernels roll where the port reads zeros, so they
    differ in the last bits, amplified through up to 7 rounds of 3x3
    inverses.

    Factor: on the intact mesh the two agree to 1e-4 of each output's
    largest entry (float32 eps is 1.2e-7; measured 2e-5). Under fracture,
    blocks held only by the regularization floor make the level
    ill-conditioned in float32: both land ~1e-2 from the float64 answer
    (measured 1.2e-2 and 8.7e-3), so there each is held to 3e-2 of it.
    Apply: given the same coefficients, 1e-4."""
    monkeypatch.setattr(pf, "CHUNK_ROWS", 4)
    D, B, fg, lg, steps = level0(seed, frac, dtype="float32")
    S = D.shape[1]
    assert -(-(-(-S // 128)) // 4) >= 2, "level fits one chunk"
    port = pcr_factor_plain(D, B, fg, lg, steps)
    kd, kx, packed = pf.pcr_level_kernel(
        tuple(jnp.asarray(D.numpy())), tuple(jnp.asarray(B.numpy())),
        jnp.asarray(fg.numpy()), jnp.asarray(lg.numpy()), steps,
        interpret=True)
    tpu = [np.asarray(x) for x in pf.unpack_coeffs(packed, steps, S)] \
        + [np.stack(kd), np.stack(kx)]
    ref = pcr_factor_plain(D.double(), B.double(), fg, lg, steps)
    for name, a, b, c in zip(("alphas", "betas", "dinv", "corners"),
                             port, tpu, ref):
        if frac == 0.0:
            assert _rel(a.numpy(), b) < 1e-4, name
        else:
            assert _rel(a.numpy(), c.numpy()) < 3e-2, name
            assert _rel(b, c.numpy()) < 3e-2, name
    r = np.random.default_rng(seed).standard_normal((3, S)).astype(
        np.float32)
    u = pcr_apply_plain(*(torch.tensor(x) for x in tpu[:3]),
                        torch.as_tensor(r)).numpy()
    ku = pf.pcr_apply_planes_kernel(packed, tuple(jnp.asarray(r)), steps, S,
                                    interpret=True)
    assert _rel(u, np.stack(ku)) < 1e-4


def test_corner_solve_is_the_pcr_apply_of_unit_columns():
    """pcr_factor's 18 corner planes equal the apply of the unit blocks at
    every path's first and last slot (the reference's XLA corner solve)."""
    D, B, fg, lg, steps = level0(12, 0.08)
    S = D.shape[1]
    al, be, dinv, xc = pcr_factor(D, B, fg, lg, steps)
    rhs = tuple(jnp.zeros((S, 6)).at[jnp.asarray(fg.numpy()), i].add(1.0)
                .at[jnp.asarray(lg.numpy()), 3 + i].add(1.0)
                for i in range(3))
    X = trj._pcr_apply(jnp.asarray(al.numpy()), jnp.asarray(be.numpy()),
                       jnp.asarray(dinv.numpy()), rhs)
    ref = np.stack([np.asarray(X[i][:, j]) for i in range(3)
                    for j in range(6)])
    assert _rel(xc.numpy(), ref) < 1e-12


def _hybrid_model(name):
    from mycelium_tpu_torch.config import hybrid_fea_config
    from mycelium_tpu_torch.fea.model import build_model
    coords, conn = {"forest900": lambda: random_forest_mesh(900, 18, 4),
                    "synthetic8000": lambda: synthetic_mesh(8000)}[name]()
    cfg = hybrid_fea_config(grip_length=grip_for(coords), tree_dense_tail=64)
    return build_model(coords, conn, cfg, "cpu"), cfg, conn


def _levels(m, cfg, conn, frac):
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
    rng = np.random.default_rng(2)
    act = rng.random(m.n_elems) >= frac
    grip = (m.top_nodes | m.bot_nodes).numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act, grip))
    return all_levels(m, torch.as_tensor(act), m.free_nodes & anch,
                      preconditioner_reg(m, cfg))


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("name", ["forest900", "synthetic8000"])
def test_k2_windows_equal_the_whole_level(name, frac):
    """K2's bound launch cuts each hybrid PCR level into K6's path-aligned
    windows: the plain factorization run window by window, with the corner
    columns from the launch's per-slot flags, equals the whole level's
    exactly (torch.equal: only the sign of a zero may differ); the launch's
    own plain version (flags back to path ends) equals pcr_factor_plain."""
    from mycelium_tpu_torch.fea.tree_factor import (n_pcr_levels,
                                                    build_pcr_launch)
    m, cfg, conn = _hybrid_model(name)
    launch = m.pcr_launch
    L = n_pcr_levels(m.tree.meta)
    assert launch.sizes == [m.tree.meta.level_offsets[i + 1]
                            - m.tree.meta.level_offsets[i] for i in range(L)]
    assert all(launch.windowed) and L >= 2
    levels = _levels(m, cfg, conn, frac)
    for li in range(L):
        D, B, fg, lg, steps = levels[li]
        whole = pcr_factor_plain(D, B, fg, lg, steps)
        for a, b in zip(launch.plain(li, D, B), whole):
            assert torch.equal(a, b)
        for a, b in zip(emulate_pcr_windows(launch, li, D, B), whole):
            assert torch.equal(a, b)
    # a window shorter than a level's longest path: that level keeps the
    # global rounds, the others are cut finer and still equal
    small = build_pcr_launch(m.tree, window=8)
    po, fgh, lgh = (m.tree.meta.path_offsets, m.tree.first_gpos.numpy(),
                    m.tree.last_gpos.numpy())
    longest = [int((lgh[po[i]:po[i + 1]] - fgh[po[i]:po[i + 1]]).max()) + 1
               for i in range(L)]
    assert small.windowed == tuple(n <= 8 for n in longest)
    assert not all(small.windowed)
    for li in range(L):
        D, B, fg, lg, steps = levels[li]
        win = emulate_pcr_windows(small, li, D, B)
        assert (win is None) == (not small.windowed[li])
        if win is not None:
            for a, b in zip(win, pcr_factor_plain(D, B, fg, lg, steps)):
                assert torch.equal(a, b)
