"""K8, a ramp step's post-solve and its record rows in one launch
(``kernels/post_solve.py``), its plain version ``post_solve_plain`` and the
rows it writes for the ramp drivers (``fea/ramp.py``).

On the CPU: ``post_solve_plain`` equals ``post_solve``'s plain arithmetic on
every step of the ramp tests' scenes and networks (stress and mask bit for
bit, the force to rounding, the counts and the flag exactly), and so do the
rows that ``post_solve`` writes there; ``dot3``, the element functions'
fixed-order dot product, gives ``(a * b).sum(dim=1)``'s bits;
``fixed_order_sum`` adds in the kernel's order, held to a per-thread
emulation of the kernel's reduction; the four ramp drivers' CPU records
are what the whole operator's post-solve gives on their own displacements,
bit for bit. On the card (skipped without one): K8 against
``post_solve_plain`` on CPU copies of the same inputs, bit for bit, in
float32 and float64; its force near the whole operator's sum; reruns give
the same bits; ``run_ramp`` and ``run_ramp_async`` give the same records;
one ``fea.post.kernel`` and no row write a step under a profiler. The file
imports no jax, so it runs on a machine with PyTorch for CUDA and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_post_solve.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mycelium_tpu_torch import scenes
from mycelium_tpu_torch.config import (FeaConfig, archive_parity_config,
                                       hybrid_fea_config)
from mycelium_tpu_torch.fea import build_model, ramp
from mycelium_tpu_torch.fea.elements import (ElementGeometry, dot3,
                                             element_forces,
                                             element_geometry_host,
                                             element_strain)
from mycelium_tpu_torch.fea.model import _build_incidence, apply_stiffness
from mycelium_tpu_torch.kernels import (PostRows, PostSolveLaunch,
                                        launch_counts, post_solve_plain,
                                        reset_launch_counts)
from mycelium_tpu_torch.kernels.post_solve import (FORCE, THREADS,
                                                   fixed_order_sum)
from mycelium_tpu_torch.meshes import synthetic_mesh
from mycelium_tpu_torch.utils import profiling
from mycelium_tpu_torch.utils.dist import initialize_single
# imported by its own name (pytest puts tests/ on sys.path): a machine
# with an unrelated installed package named "tests" shadows tests.*
from torch_support import cuda_device, random_forest_mesh  # noqa: F401

RECORDS = ("stress_record", "active_record", "disp_record", "force_disp",
           "cg_iters")
# the force against the whole operator's sum, over the sum of its terms'
# magnitudes (float32 sums over a node's ends and then the grip)
FORCE_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


def _scene_case(name, operator="chain"):
    sc = scenes.SCENES[name]()
    return sc.coords, sc.conn, archive_parity_config(
        operator=operator, precond="tree",
        **scenes.ARCHIVE_SCENE_CONFIGS[name])


def _forest_case(dtype, operator="chain", precond="tree"):
    coords, conn = random_forest_mesh(400, 10, 2)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return coords, conn, FeaConfig(
        dtype=dtype, operator=operator, precond=precond,
        rtol=1e-10 if dtype == "float64" else 1e-6, tree_reg_rel=1e-7,
        grip_length=0.1 * ext, displacement_max=0.05 * ext)


def _fracture_case():
    """test_torch_records.py's: 1,500 nodes pulled to 0.06 mm."""
    coords, conn = synthetic_mesh(1500, seed=0)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return coords, conn, hybrid_fea_config(displacement_max=0.06,
                                           grip_length=0.3 * ext)


CASES = {**{n: (lambda n=n: _scene_case(n)) for n in scenes.SCENES},
         "test_X scatter": lambda: _scene_case("test_X", "scatter"),
         "forest f64": lambda: _forest_case("float64"),
         "forest f32": lambda: _forest_case("float32"),
         # the CLI's reference preset in float64 (ELL, block-Jacobi)
         "forest f64 ell": lambda: _forest_case("float64", "ell",
                                                "block_jacobi"),
         "fracture": _fracture_case}
_RAMPS = {}


def _ramp(name: str, device="cpu"):
    """(coords, conn, configuration, model, run_ramp's result) of case
    ``name`` on ``device``, once a process."""
    key = (name, str(device))
    if key not in _RAMPS:
        coords, conn, cfg = CASES[name]()
        m = build_model(coords, conn, cfg, device)
        _RAMPS[key] = (coords, conn, cfg, m,
                       ramp.run_ramp(coords, conn, cfg, model=m))
    return _RAMPS[key]


def _steps(model, res):
    """(u, the mask the step solved with) of each recorded step."""
    for k in range(len(res.active_record)):
        u = torch.as_tensor(res.disp_record[k], dtype=model.dtype)
        prev = np.ones(model.n_elems, bool) if k == 0 \
            else res.active_record[k - 1]
        yield u.reshape(-1, 3).to(model.device), \
            torch.as_tensor(prev).to(model.device)


def _bits(t):
    """The raw bits of a tensor, as a numpy array of unsigned integers."""
    a = t.detach().cpu().numpy()
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _plain(model, cfg, u, active, converged=True, iters=7):
    """``post_solve_plain`` of the model's step, on the CPU."""
    c = lambda t: t.cpu()  # noqa: E731
    g = model.geom
    return post_solve_plain(
        c(u), c(model.conn),
        ElementGeometry(n=c(g.n), length=c(g.length), k_ax=c(g.k_ax),
                        k_bd=c(g.k_bd)),
        c(model.top_nodes), c(active), cfg.e_mod, cfg.max_strain,
        converged, iters)


def _force_terms(model, u, active):
    """Σ|f_y| over the element ends on the top grip: the scale of the
    reaction's sum."""
    f = element_forces(u, model.conn, model.geom,
                       active)[:, 1].abs().double()
    top = model.top_nodes.double()
    return float(((top[model.conn[:, 0]] + top[model.conn[:, 1]]) * f).sum())


def _operator_post_solve(model, cfg, u, active):
    """The post-solve arithmetic the CPU keeps, written out: the top grip's
    y-reactions of the whole operator, strain, stress, fracture."""
    f_react = apply_stiffness(model, u, active,
                              "scatter" if cfg.operator == "scatter"
                              else "ell")
    total_force = torch.where(model.top_nodes, f_react[:, 1], 0.0).sum()
    strain = element_strain(u, model.conn, model.geom)
    stress = torch.where(active, cfg.e_mod * strain, 0.0)
    return stress, active & (strain.abs() <= cfg.max_strain), total_force


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_post_solve(name):
    _, _, cfg, m, res = _ramp(name)
    fractured = 0
    for k, (u, prev) in enumerate(_steps(m, res)):
        written = _cpu_rows(m)
        stress, act, force = ramp.post_solve(m, cfg, u, prev, written,
                                             k % 2 == 0, k)
        rows = _plain(m, cfg, u, prev, converged=k % 2 == 0, iters=k)
        np.testing.assert_array_equal(_bits(rows.stress), _bits(stress))
        np.testing.assert_array_equal(rows.active.numpy(), act.numpy())
        np.testing.assert_array_equal(_bits(rows.disp), _bits(u.reshape(-1)))
        n_frac = int((prev & ~act).sum())
        fractured += n_frac
        assert rows.status[:FORCE].tolist() == [float(k % 2 == 0),
                                                float(act.sum()), float(k)]
        assert bool(rows.changed) == (n_frac > 0)
        assert rows.status.dtype == torch.float64
        tol = FORCE_TOL[m.dtype] * _force_terms(m, u, prev)
        assert abs(float(rows.status[FORCE]) - float(force)) <= tol, k
        # the rows the CPU's post-solve wrote: the plain counterpart's but
        # for the force, which is the whole operator's
        for f in ("stress", "active", "disp", "changed"):
            np.testing.assert_array_equal(_bits(getattr(written, f)),
                                          _bits(getattr(rows, f)),
                                          err_msg=f"{f} at {k}")
        assert written.status[:FORCE].tolist() == \
            rows.status[:FORCE].tolist()
        assert _bits(written.status[FORCE]) == \
            _bits(force.to(torch.float64))
    assert fractured > 0, "nothing fractured"


def _cpu_rows(model):
    """A step's record rows on the CPU, filled with what no step writes."""
    return PostRows(torch.full((model.n_elems,), float("nan"),
                               dtype=model.dtype),
                    torch.zeros(model.n_elems, dtype=torch.bool),
                    torch.full((3 * model.n_nodes,), float("nan"),
                               dtype=model.dtype),
                    torch.full((4,), float("nan"), dtype=torch.float64),
                    torch.ones((), dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dot3_is_the_sum_of_the_products(dtype):
    """``dot3``'s fixed order gives ``(a * b).sum(dim=1)``'s bits on the
    CPU, so the element functions kept their bits when they took it."""
    g = torch.Generator().manual_seed(3)
    for e in (1, 7, 4097):
        a = torch.randn((e, 3), generator=g, dtype=dtype) * torch.exp2(
            torch.randint(-20, 20, (e, 3), generator=g).to(dtype))
        b = torch.randn((e, 3), generator=g, dtype=dtype)
        np.testing.assert_array_equal(_bits(dot3(a, b)),
                                      _bits((a * b).sum(dim=1)))


def _per_thread_sum(terms):
    """The kernel's reduction, thread by thread and lane by lane, in
    Python floats: a block's warps by shuffle-down halving, its warps in
    order; the last block's thread t over blocks t, t + 256, ...; the same
    block reduction of those."""
    def block(vals):
        warps = []
        for w in range(THREADS // 32):
            lane = list(vals[32 * w:32 * w + 32])
            o = 16
            while o:
                lane = [lane[i] + lane[i + o] for i in range(o)]
                o //= 2
            warps.append(lane[0])
        s = 0.0
        for x in warps:
            s = s + x
        return s

    e = len(terms)
    blocks = max(1, -(-e // THREADS))
    vals = list(terms) + [0.0] * (blocks * THREADS - e)
    part = [block(vals[b * THREADS:(b + 1) * THREADS]) for b in range(blocks)]
    lanes = []
    for t in range(THREADS):
        s = 0.0
        for i in range(t, blocks, THREADS):
            s = s + part[i]
        lanes.append(s)
    return block(lanes)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 3000, 70000])
def test_fixed_order_sum_is_the_kernels_order(n):
    rng = np.random.default_rng(n)
    terms = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    terms[rng.random(n) < 0.3] = 0.0
    terms[rng.random(n) < 0.05] = -0.0
    want = _per_thread_sum(terms.tolist())
    got = fixed_order_sum(torch.as_tensor(terms)[None])[0]
    assert np.float64(want).view(np.uint64) == \
        np.float64(float(got)).view(np.uint64)


def test_launch_refuses_a_cpu_model():
    _, _, cfg, m, _ = _ramp("test_I")
    launch = m.post_launch
    assert isinstance(launch, PostSolveLaunch)
    assert launch.io_bytes() == 74 * m.n_elems + 49 * m.n_nodes + 33  # f64
    u = torch.zeros((m.n_nodes, 3), dtype=m.dtype)
    act = torch.ones(m.n_elems, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        launch.launch(u, act, None, cfg.e_mod, cfg.max_strain, True, 0)


def _sharded(coords, conn, cfg, model):
    """``run_ramp_sharded`` on one gloo rank of this process."""
    import torch.distributed as dist
    initialize_single("cpu")
    try:
        return ramp.run_ramp_sharded(coords, conn, cfg, device="cpu",
                                     model=model)
    finally:
        dist.destroy_process_group()


DRIVERS = {"run_ramp": lambda c, e, f, m: ramp.run_ramp(c, e, f, model=m),
           "run_ramp_async": lambda c, e, f, m: ramp.run_ramp_async(
               c, e, f, model=m),
           "run_ramp_scan": lambda c, e, f, m: ramp.truncate_after_fracture(
               ramp.run_ramp_scan(c, e, f, model=m)),
           "run_ramp_sharded": _sharded}


@pytest.mark.parametrize("name", ["test_X", "forest f32"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_cpu_records_keep_the_operator_post_solve(name, driver):
    """Each step's stress, mask and force of a CPU driver are the whole
    operator's post-solve on the step's own displacement and previous mask,
    bit for bit; the device keepers' records equal ``run_ramp``'s."""
    coords, conn, cfg, m, loop = _ramp(name)
    res = DRIVERS[driver](coords, conn, cfg, m)
    assert (~res.active_record[-1]).any(), "no element fractured"
    for k, (u, prev) in enumerate(_steps(m, res)):
        stress, act, force = _operator_post_solve(m, cfg, u, prev)
        np.testing.assert_array_equal(_bits(stress),
                                      res.stress_record[k].view(
                                          _bits(stress).dtype))
        np.testing.assert_array_equal(act.numpy(), res.active_record[k])
        assert res.force_disp[k, 1] == float(force), k
    if driver != "run_ramp_sharded":
        for f in RECORDS:
            np.testing.assert_array_equal(getattr(res, f), getattr(loop, f),
                                          err_msg=f)


# ---- the card ---------------------------------------------------------------

def _mesh_launch(coords, conn, cfg, device):
    """(K8 bound to a mesh's tensors, a model-like namespace of them): the
    connectivity, geometry and top grip of ``build_model`` and the ELL
    tables ``apply_stiffness`` reads, without the rest of the model."""
    from types import SimpleNamespace
    dt = {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]
    n, length, k_ax, k_bd = element_geometry_host(coords, conn, cfg)
    y = coords[:, 1]
    top = (np.abs(y - y.max()) < cfg.grip_length) & \
        ~(np.abs(y - y.min()) < cfg.grip_length)
    incident, sign, _ = _build_incidence(np.asarray(conn, np.int32),
                                         len(coords))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt,  # noqa
                                  device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa: E731
                                  device=device)
    m = SimpleNamespace(
        conn=i(conn), incident=i(incident), sign=f(sign),
        geom=ElementGeometry(n=f(n), length=f(length), k_ax=f(k_ax),
                             k_bd=f(k_bd)),
        top_nodes=torch.as_tensor(top, device=device), dtype=dt,
        n_nodes=len(coords), n_elems=len(conn))
    return PostSolveLaunch(m.conn, m.geom, m.top_nodes), m


def _drawn_inputs(m, seed, scale):
    """(u, active) pairs on the model's card: displacements drawn so that
    some elements pass the fracture strain, under the intact mask and
    masks with 1-30% of the elements inactive."""
    rng = np.random.default_rng(seed)
    dev = m.conn.device
    for frac in (0.0, 0.01, 0.3):
        u = rng.standard_normal((m.n_nodes, 3)) * scale
        act = rng.random(m.n_elems) >= frac
        yield (torch.as_tensor(u, dtype=m.dtype, device=dev),
               torch.as_tensor(act, device=dev))


def _card_inputs(case, dtype, device):
    """(launch, model-like namespace, configuration, [(u, active)]) of a
    card comparison: the fracturing forest's ramp steps (from the CPU
    ramp), or drawn displacements on the 309k-DOF mesh."""
    if case == "forest":
        name = {"float32": "forest f32", "float64": "forest f64"}[dtype]
        coords, conn, cfg, cpu, res = _ramp(name)
        launch, m = _mesh_launch(coords, conn, cfg, device)
        pairs = [(u.to(device), a.to(device)) for u, a in _steps(cpu, res)]
        return launch, m, cfg, pairs
    coords, conn = synthetic_mesh(103000, seed=0)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    cfg = hybrid_fea_config(dtype=dtype, grip_length=0.3 * ext)
    launch, m = _mesh_launch(coords, conn, cfg, device)
    # a 0.05 mm element fractures past 1.8% strain: 9e-4 mm of stretch
    return launch, m, cfg, list(_drawn_inputs(m, 24, 6e-4))


def _k8(launch, cfg, u, act, converged=True, iters=7):
    rows = launch.launch(u, act, launch.rows(), cfg.e_mod, cfg.max_strain,
                         converged, iters)
    torch.cuda.synchronize()
    return rows


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["forest", "309k"])
def test_k8_equals_plain(cuda_device, case, dtype):  # noqa: F811
    launch, m, cfg, pairs = _card_inputs(case, dtype, cuda_device)
    fractured = 0
    for k, (u, act) in enumerate(pairs):
        got = _k8(launch, cfg, u, act, converged=k % 3 > 0, iters=k)
        want = _plain(m, cfg, u, act, converged=k % 3 > 0, iters=k)
        for f in ("stress", "active", "disp", "status", "changed"):
            np.testing.assert_array_equal(_bits(getattr(got, f)),
                                          _bits(getattr(want, f)),
                                          err_msg=f"{f} at {k}")
        fractured += int(want.changed)
    assert fractured > 0, "no input fractured an element"


@pytest.mark.parametrize("case", ["forest", "309k"])
def test_k8_force_near_the_operator_sum(cuda_device, case):  # noqa: F811
    launch, m, cfg, pairs = _card_inputs(case, "float32", cuda_device)
    for u, act in pairs:
        rows = _k8(launch, cfg, u, act)
        ell = torch.where(m.top_nodes, apply_stiffness(m, u, act)[:, 1],
                          0.0).sum()
        tol = FORCE_TOL[torch.float32] * _force_terms(m, u, act)
        assert abs(float(rows.status[FORCE]) - float(ell)) <= tol


def test_k8_reruns_give_the_same_bits(cuda_device):  # noqa: F811
    launch, m, cfg, pairs = _card_inputs("309k", "float32", cuda_device)
    for u, act in pairs:
        first = _k8(launch, cfg, u, act)
        for _ in range(3):
            again = _k8(launch, cfg, u, act)
            for f in ("stress", "active", "disp", "status", "changed"):
                np.testing.assert_array_equal(_bits(getattr(again, f)),
                                              _bits(getattr(first, f)))


def test_k8_refuses_bad_tensors(cuda_device):  # noqa: F811
    launch, m, cfg, pairs = _card_inputs("forest", "float32", cuda_device)
    u, act = pairs[0]
    bad = [(u.double(), act), (u.t().contiguous().t(), act),
           (u, act.to(torch.uint8)), (u.cpu(), act), (u[:-1], act)]
    for bu, ba in bad:
        with pytest.raises(ValueError):
            launch.launch(bu, ba, launch.rows(), cfg.e_mod, cfg.max_strain,
                          True, 0)
    rows = launch.rows()
    with pytest.raises(ValueError):
        launch.launch(u, act, rows._replace(status=rows.status.float()),
                      cfg.e_mod, cfg.max_strain, True, 0)


@pytest.mark.parametrize("name", ["fracture", "forest f64 ell"])
def test_card_ramps_give_equal_records(cuda_device, name):  # noqa: F811
    coords, conn, cfg, m, _ = _ramp(name, cuda_device)
    loop = ramp.run_ramp(coords, conn, cfg, model=m)
    res = ramp.run_ramp_async(coords, conn, cfg, model=m)
    assert (~loop.active_record[-1]).any(), "no element fractured"
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(loop, f),
                                      err_msg=f)


def test_card_counts_one_launch_a_step(cuda_device):  # noqa: F811
    coords, conn, cfg, m, _ = _ramp("fracture", cuda_device)
    ramp.run_ramp_async(coords, conn, cfg, model=m)
    reset_launch_counts()
    profiling.reset_readings()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = ramp.run_ramp_async(coords, conn, cfg, model=m)
    got = profiling.readings()
    profiling.reset_readings()
    steps = len(res.active_record)
    assert launch_counts()["post_solve"] == steps
    assert got["fea.post.kernel"] == got["fea.post_solve"]["count"] == steps
    assert got["fea.sync.flag"]["count"] == steps
    assert "fea.records.write" not in got
