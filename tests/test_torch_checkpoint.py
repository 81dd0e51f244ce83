"""Checkpoint and resume (``io/checkpoint.py``, the checkpoint arguments of
``run_growth`` and ``run_ramp``) against the unsplit runs and across the
two packages:

- growth split at step 7 of 14 and resumed equals the unsplit run bit for
  bit in every state field, the anastomosis grid (rebuilt from the
  state's backlog) and the history, with the port's ``TorchDraws``;
- a growth state the JAX package saved resumes in the port with
  ``JaxDraws`` started from the file's key and follows JAX's unsplit run
  within the growth parity tests' tolerance (float64: integer fields
  equal, float fields within 1e-10 of each field's largest magnitude);
- ``checkpoint_every`` writes an absolute step; a draw state written on
  another device type is refused;
- the ramp file's round trip, and its field names are the JAX package's;
- a ramp resumed from a checkpoint equals the unsplit run exactly
  (float64 on the node path, and float32 on K6's plain version, whose
  warm start comes from the file), also past full fracture;
- a ramp file the JAX package wrote resumes in the port, and one the port
  wrote resumes in the JAX package, each within 1e-6 of the JAX package's
  unsplit run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mycelium_tpu import scenes as jscenes
from mycelium_tpu.config import GrowthConfig as JGrowthConfig
from mycelium_tpu.config import archive_parity_config
from mycelium_tpu.fea.ramp import run_ramp as jrun_ramp
from mycelium_tpu.growth.step import run_growth as jrun_growth
from mycelium_tpu.io import checkpoint as jckpt
from mycelium_tpu_torch.config import GrowthConfig, hybrid_fea_config
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import run_ramp
from mycelium_tpu_torch.growth import run_growth
from mycelium_tpu_torch.io.checkpoint import (GROWTH_FIELDS,
                                              load_growth_state,
                                              load_ramp_state,
                                              save_ramp_state)
from tests.torch_support import JaxDraws, grip_for, synthetic_mesh

CFG = GrowthConfig(t_steps=14, max_segments=4096, max_hyphae=2048)
RECORDS = ("stress_record", "active_record", "disp_record", "force_disp",
           "cg_iters")
RAMP_FIELDS = {"step", "active", "u_prev", "rec_stress", "rec_active",
               "rec_disp", "rec_fd", "rec_solve_secs", "rec_iters"}


def _equal_states(a, b):
    for k in GROWTH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if torch.is_tensor(x):
            assert torch.equal(x, y), k
        else:
            assert x == y, k
    for k in ("ids", "geo", "count", "n_seen"):
        x, y = getattr(a.grid, k), getattr(b.grid, k)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), k


def test_growth_resume_bit_identical(tmp_path):
    ckpt = str(tmp_path / "growth.npz")
    st_full, _, hist_full = run_growth(CFG, device="cpu")
    st_half, _, hist_half = run_growth(
        dataclasses.replace(CFG, t_steps=7), device="cpu",
        checkpoint_path=ckpt, checkpoint_every=7)
    st_loaded, draws = load_growth_state(ckpt, CFG, "cpu")
    assert st_loaded.step == 7 and st_loaded.grid.n_seen == 0
    _equal_states(st_loaded, dataclasses.replace(
        st_half, grid=st_loaded.grid))
    st_res, _, hist_res = run_growth(CFG, device="cpu",
                                     initial_state=st_loaded, draws=draws)
    assert [h["step"] for h in hist_res] == list(range(7, 14))
    assert hist_half + hist_res == hist_full
    _equal_states(st_res, st_full)
    assert int((st_full.state == 3).sum()) > 0, "no tip anastomosed"
    with pytest.raises(ValueError, match="draw source"):
        run_growth(CFG, device="cpu", initial_state=st_loaded)


def test_growth_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package's file holds a key, not a draw state: the port
    resumes its state with the key's stream replayed (JaxDraws)."""
    cfg = GrowthConfig(t_steps=14, max_segments=1 << 12, max_hyphae=1 << 11,
                       dtype="float64", dish_size=3.0, substrate_width=3.0)
    jcfg = JGrowthConfig(**dataclasses.asdict(cfg))
    jfull, _, jhist = jrun_growth(jcfg)
    ckpt = str(tmp_path / "jax_growth.npz")
    jrun_growth(dataclasses.replace(jcfg, t_steps=7), checkpoint_path=ckpt,
                checkpoint_every=7)
    st, draws = load_growth_state(ckpt, cfg, "cpu")
    assert draws is None and st.step == 7
    st_res, _, hist = run_growth(
        cfg, device="cpu", initial_state=st,
        draws=JaxDraws.from_key(np.load(ckpt)["key"]))
    for k in ("state", "prev", "hypha", "tip"):
        np.testing.assert_array_equal(getattr(st_res, k).numpy(),
                                      np.asarray(getattr(jfull, k)), k)
    for k in ("n_seg", "n_hyp"):
        assert getattr(st_res, k) == int(getattr(jfull, k)), k
    for k in ("start", "end", "theta", "phi", "sub", "env_e"):
        ref = np.asarray(getattr(jfull, k))
        got = getattr(st_res, k).numpy()
        scale = max(float(np.abs(ref).max()), 1e-300)
        assert np.abs(got - ref).max() <= 1e-10 * scale, k
    for row, jrow in zip(hist, jhist[7:]):
        assert row["step"] == jrow["step"]
        for key, v in jrow.items():
            if key == "total_length_mm":
                assert row[key] == pytest.approx(v, rel=1e-10)
            else:
                assert row[key] == v, key


def test_growth_checkpoint_every(tmp_path):
    ckpt = str(tmp_path / "auto.npz")
    run_growth(dataclasses.replace(CFG, t_steps=6), device="cpu",
               checkpoint_path=ckpt, checkpoint_every=4)
    st, draws = load_growth_state(ckpt, CFG, "cpu")
    assert st.step == 4          # (t + 1) % 4 == 0: after step index 3
    data = dict(np.load(ckpt))
    assert "key" not in data and "grid" not in data
    assert data["draw_state"].dtype == np.uint8
    assert str(data["draw_device"]) == "cpu"
    for k in ("n_seg", "n_hyp", "step"):
        assert data[k].shape == ()
    data["draw_device"] = np.asarray("cuda")
    np.savez(str(tmp_path / "cuda.npz"), **data)
    with pytest.raises(ValueError, match="cuda generator"):
        load_growth_state(str(tmp_path / "cuda.npz"), CFG, "cpu")


def test_growth_checkpoint_keeps_the_jax_names(tmp_path):
    """Every array field of the JAX package's state is in the port's file
    under its name, with its dtype and shape; ``key`` gives way to the
    draw state."""
    ckpt, jckpt_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cfg = dataclasses.replace(CFG, t_steps=3)
    st, _, _ = run_growth(cfg, device="cpu", checkpoint_path=ckpt,
                          checkpoint_every=3)
    jrun_growth(JGrowthConfig(**dataclasses.asdict(cfg)),
                checkpoint_path=jckpt_path, checkpoint_every=3)
    port, ref = np.load(ckpt), np.load(jckpt_path)
    assert set(ref.files) - {"key"} == set(port.files) - {"draw_state",
                                                           "draw_device"}
    for k in set(ref.files) - {"key"}:
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].shape == ref[k].shape, k


def test_ramp_state_roundtrip(tmp_path):
    path = str(tmp_path / "ramp.npz")
    rng = np.random.default_rng(0)
    active = rng.random(50) > 0.5
    u = rng.normal(size=(30, 3))
    recs = {"fd": rng.normal(size=(5, 2)), "iters": np.arange(5)}
    save_ramp_state(path, 5, active, u, recs)
    step, active2, u2, recs2 = load_ramp_state(path)
    assert step == 5
    np.testing.assert_array_equal(active, active2)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(recs["fd"], recs2["fd"])
    # the JAX package reads it
    jstep, jactive, ju, jrecs = jckpt.load_ramp_state(path)
    assert jstep == 5 and set(jrecs) == {"fd", "iters"}
    np.testing.assert_array_equal(ju, u)


def _scene_x(n_steps=10, **kw):
    sc = jscenes.test_X()
    return sc.coords, sc.conn, archive_parity_config(n_steps=n_steps, **kw)


@pytest.mark.parametrize("every", [6, 3])
def test_ramp_resume_equals_unsplit(tmp_path, every):
    """float64 on the node path: every record of the resumed run equals
    the unsplit run's (every=3 checkpoints past the full fracture at step
    10 too)."""
    coords, conn, cfg = _scene_x()
    full = run_ramp(coords, conn, cfg, device="cpu")
    ckpt = str(tmp_path / "fea.npz")
    run_ramp(coords, conn, cfg, device="cpu", checkpoint_path=ckpt,
             checkpoint_every=every)
    assert set(np.load(ckpt).files) == RAMP_FIELDS
    step = load_ramp_state(ckpt)[0]
    assert step == (len(full.cg_iters) // every) * every
    res = run_ramp(coords, conn, cfg, device="cpu", resume_from=ckpt)
    assert (~full.active_record[-1]).all(), "no full fracture"
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(full, f),
                                      err_msg=f)


def test_ramp_resume_on_the_tree_kernel_route(tmp_path):
    """float32 on K6's plain version (the route 'tree_cg'), with fracture:
    the resumed records equal the unsplit run's bit for bit."""
    coords, conn = synthetic_mesh(2000)
    cfg = hybrid_fea_config(n_steps=12, displacement_max=0.025,
                            grip_length=grip_for(coords))
    model = build_model(coords, conn, cfg, "cpu")
    assert model.tree_kernel
    full = run_ramp(coords, conn, cfg, model=model)
    n_active = full.active_record.sum(1)
    # elements fracture on both sides of the split
    assert n_active[6] < n_active[0] and n_active[-1] < n_active[6]
    ckpt = str(tmp_path / "fea.npz")
    run_ramp(coords, conn, cfg, model=model, checkpoint_path=ckpt,
             checkpoint_every=7)
    assert load_ramp_state(ckpt)[0] == 7
    res = run_ramp(coords, conn, cfg, model=model, resume_from=ckpt)
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(full, f),
                                      err_msg=f)


def _within(a, b, tol):
    for f in RECORDS:
        x, y = getattr(a, f).astype(float), getattr(b, f).astype(float)
        assert x.shape == y.shape, f
        if f == "cg_iters":
            continue
        scale = max(float(np.abs(y).max()), 1e-300)
        assert np.abs(x - y).max() <= tol * scale, f


def test_jax_ramp_checkpoint_resumes_in_the_port(tmp_path):
    coords, conn, cfg = _scene_x()
    jfull = jrun_ramp(coords, conn, cfg)
    ckpt = str(tmp_path / "jax_fea.npz")
    jrun_ramp(coords, conn, cfg, checkpoint_path=ckpt, checkpoint_every=6)
    res = run_ramp(coords, conn, cfg, device="cpu", resume_from=ckpt)
    _within(res, jfull, 1e-6)
    np.testing.assert_array_equal(res.active_record, jfull.active_record)


def test_port_ramp_checkpoint_resumes_in_jax(tmp_path):
    coords, conn, cfg = _scene_x()
    jfull = jrun_ramp(coords, conn, cfg)
    ckpt = str(tmp_path / "port_fea.npz")
    run_ramp(coords, conn, cfg, device="cpu", checkpoint_path=ckpt,
             checkpoint_every=6)
    res = jrun_ramp(coords, conn, cfg, resume_from=ckpt)
    _within(res, jfull, 1e-6)
    np.testing.assert_array_equal(res.active_record, jfull.active_record)
