"""The pull test in float64, written from the upstream ``src/fea_solver.py``
(YiKwanwoo2/mycelium-fea-project) with NumPy and SciPy only.

- Element (``fea_solver.py:30-68``): an axial truss term (EA/L)·n⊗n plus an
  isotropic transverse penalty (12EI/L³)·(I − n⊗n), three translational
  DOF a node, L clamped at 1e-12; A = 3.14·((d/2)² − (d/2 − t)²), I =
  A·0.001.
- Assembly (``:74-106``): the 6x6 blocks of the active elements summed into
  a 3N x 3N sparse matrix, DOF 3·node + axis.
- Grips (``:207-245``): |y − y_max| < grip_length is the top grip, |y −
  y_min| < grip_length the bottom one (bottom wins where both hold),
  prescribed (0, ±dy, 0).
- Reachability: nodes with no path of active elements to a grip are pinned
  at zero (what the upstream's regularised direct solve gives them), found
  with ``scipy.sparse.csgraph.connected_components``.
- Solve (``:112-135``): K_ff u_f = −K_fk u_k with reg·I on K_ff, by a
  sparse LU (``splu``); the response is linear in dy, so one solve at a
  unit pull serves every step of one active set.
- Strain, stress, fracture, reactions (``:257-285``): strain = n·(u2 −
  u1)/L, stress = E·strain on the elements active before the step, an
  element breaks when |strain| > max_strain, the force is the sum of the
  y-reactions K·u over the top grip.

``precision="tf32"`` is the control: the reference computed as a program
that runs its products in TF32 would (tensor cores: each product's operands
rounded to TF32, float32's exponent with 10 bits of mantissa; products and
sums kept): each element's direction, stiffnesses and 3x3 block, and the
displacement differences the element operator and the strain multiply,
are rounded. The element operator is applied element by element,
K_e·(u_b − u_a) added to b and taken from a, as the port applies it, so
each element keeps its rigid-body balance; the matrix the solve factors is
the exact sum of the rounded blocks, and the solve itself stays float64
(which favours the control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.sparse import coo_matrix, identity
from scipy.sparse.csgraph import connected_components
from scipy.sparse.linalg import splu


class Physics(NamedTuple):
    e_mod: float
    area: float
    moi: float
    max_strain: float
    grip_length: float
    reg: float
    n_steps: int

    @classmethod
    def of(cls, fea: dict, grip_length: float) -> "Physics":
        """From a configuration's ``fea`` fields (the FeaConfig names)."""
        d, t = fea["d"], fea["t"]
        area = 3.14 * ((d / 2) ** 2 - (d / 2 - t) ** 2)
        return cls(fea["e_mod"], area, area * 0.001, fea["max_strain"],
                   grip_length, fea["reg"], fea["n_steps"])


def to_tf32(a) -> np.ndarray:
    """``a`` rounded to the nearest TF32 value (ties to even), as
    float64."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0xFFF + ((b >> 13) & 1)) >> 13) << 13
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


ROUND = {"float64": lambda a: np.asarray(a, np.float64), "tf32": to_tf32}


class Mesh:
    """One network and what does not change over a pull test: the
    element geometry and stiffness blocks, the grips."""

    def __init__(self, coords, conn, phys: Physics,
                 precision: str = "float64"):
        self.rnd = ROUND[precision]
        self.coords = np.asarray(coords, np.float64)
        self.conn = np.asarray(conn, np.int64).reshape(-1, 2)
        self.phys = phys
        self.n_nodes = self.coords.shape[0]
        d = self.coords[self.conn[:, 1]] - self.coords[self.conn[:, 0]]
        self.length = np.maximum(np.linalg.norm(d, axis=1), 1e-12)
        self.n = self.rnd(d / self.length[:, None])
        k_ax = self.rnd(phys.e_mod * phys.area / self.length)
        k_bd = self.rnd(12.0 * phys.e_mod * phys.moi / self.length ** 3)
        nn = self.n[:, :, None] * self.n[:, None, :]
        self.blocks = self.rnd(k_ax[:, None, None] * nn + k_bd[:, None, None]
                               * (np.eye(3) - nn))                # (E,3,3)
        y = self.coords[:, 1]
        bot = np.abs(y - y.min()) < phys.grip_length
        self.top = (np.abs(y - y.max()) < phys.grip_length) & ~bot
        self.bot = bot
        self.grip = self.top | self.bot

    def stiffness(self, active):
        """The assembled 3N x 3N matrix of the ``active`` elements (CSR)."""
        e = np.nonzero(active)[0]
        a, b = self.conn[e, 0], self.conn[e, 1]
        blk = self.blocks[e]
        i3 = np.arange(3)
        rows, cols, vals = [], [], []
        for p, q, s in ((a, a, 1.0), (b, b, 1.0), (a, b, -1.0),
                        (b, a, -1.0)):
            rows.append((3 * p[:, None, None] + i3[None, :, None])
                        .repeat(3, axis=2).ravel())
            cols.append((3 * q[:, None, None] + i3[None, None, :])
                        .repeat(3, axis=1).ravel())
            vals.append((s * blk).ravel())
        n3 = 3 * self.n_nodes
        return coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(n3, n3)).tocsr()

    def apply(self, active, u) -> np.ndarray:
        """K·u of the ``active`` elements, element by element: each
        element's force K_e·(u_b − u_a) added to b and taken from a,
        (N, 3)."""
        e = np.nonzero(active)[0]
        a, b = self.conn[e, 0], self.conn[e, 1]
        d = self.rnd(u[b] - u[a])
        f = np.einsum("eij,ej->ei", self.blocks[e], d)
        n = self.n_nodes
        return np.stack([np.bincount(b, f[:, i], n)
                         - np.bincount(a, f[:, i], n) for i in range(3)],
                        axis=1)

    def anchored(self, active) -> np.ndarray:
        """Nodes joined to a grip by a path of active elements."""
        e = self.conn[np.asarray(active, bool)]
        n = self.n_nodes
        adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                         shape=(n, n))
        _, labels = connected_components(adj, directed=False)
        return np.isin(labels, np.unique(labels[self.grip]))

    def free(self, active) -> np.ndarray:
        """Nodes the solve moves: anchored and in no grip."""
        return self.anchored(active) & ~self.grip

    def grips_at(self, dy: float) -> np.ndarray:
        """The prescribed displacement, (N, 3): the top grip at +dy in y,
        the bottom at −dy, every other node at zero."""
        uk = np.zeros((self.n_nodes, 3))
        uk[self.top, 1] = dy
        uk[self.bot, 1] = -dy
        return uk

    def residual(self, active, free, u) -> float:
        """|K_ff u_f + K_fk u_k| under this mesh's operator with reg·I on
        K_ff, u_k the grip nodes' part of ``u``: how far ``u`` is from
        equilibrium on the free nodes ``free``."""
        r = self.apply(active, u)[free] + self.phys.reg * u[free]
        return float(np.linalg.norm(r))

    def load(self, active, free, dy: float) -> float:
        """|K_fk u_k| with the grips at dy."""
        return float(np.linalg.norm(self.apply(active,
                                               self.grips_at(dy))[free]))

    def unit_pull(self, active) -> np.ndarray:
        """u at a unit pull of the ``active`` elements: the top grip at +1
        in y, the bottom at −1, as (N, 3)."""
        k = self.stiffness(active)
        free = np.repeat(self.free(active), 3)
        uk = self.grips_at(1.0)
        u = uk.ravel().copy()
        fi = np.nonzero(free)[0]
        if len(fi):
            kff = k[fi][:, fi] + self.phys.reg * identity(len(fi))
            rhs = -self.apply(active, uk).ravel()[fi]
            u[fi] = splu(kff.tocsc(), permc_spec="MMD_AT_PLUS_A").solve(rhs)
        return u.reshape(-1, 3)

    def strain(self, u) -> np.ndarray:
        du = u[self.conn[:, 1]] - u[self.conn[:, 0]]
        return (self.n * self.rnd(du)).sum(axis=1) / self.length

    def force(self, active, u) -> float:
        """The top grip's total y-reaction of ``u`` under the ``active``
        elements."""
        return float(self.apply(active, u)[self.top, 1].sum())


def step_dy(dmax: float, n_steps: int, k: int) -> float:
    """The top grip's displacement at step ``k``, as the ramp sets it."""
    return dmax * (k / (n_steps - 1))


class Records(NamedTuple):
    """A pull test's records, the port's ``RampResult`` layout."""
    stress: np.ndarray     # (n_rec, E)
    active: np.ndarray     # (n_rec, E) bool, after each step
    disp: np.ndarray       # (n_rec, 3N)
    force_disp: np.ndarray  # (n_rec, 2) [2·dy, force]


def ramp(mesh: Mesh, dmax: float) -> Records:
    """The whole pull test in the mesh's precision, with the upstream's
    early stop once no element is left: what the control puts in the
    program's place."""
    p = mesh.phys
    active = np.ones(len(mesh.conn), bool)
    unit = None
    out = ([], [], [], [])
    for step in range(p.n_steps):
        if unit is None:
            unit = mesh.unit_pull(active)
        dy = step_dy(dmax, p.n_steps, step)
        u = unit * dy
        strain = mesh.strain(u)
        stress = np.where(active, p.e_mod * strain, 0.0)
        new = active & (np.abs(strain) <= p.max_strain)
        for rec, v in zip(out, (stress, new, u.ravel(),
                                [2 * dy, mesh.force(active, u)])):
            rec.append(v)
        if not np.array_equal(new, active):
            unit = None
        active = new
        if not active.any():
            break
    return Records(*(np.asarray(r) for r in out))


def segments(active_record: np.ndarray, n_rec: int) -> list:
    """The runs of steps that share the active set they start from:
    (first step, last step, that set)."""
    out = []
    before = np.ones(active_record.shape[1], bool)
    first = 0
    for k in range(1, n_rec + 1):
        nxt = active_record[k - 1]
        if k == n_rec or not np.array_equal(nxt, before):
            out.append((first, k - 1, before))
            before, first = nxt, k
    return out


def check_ramp(mesh: Mesh, dmax: float, rec: Records, rng,
               extra_segments: int) -> dict:
    """Judge a pull test's records step by step from its own active sets.

    A step starts from the set the records hold after the step before it
    (the port's fracture pattern depends on its route and rounding, so the
    reference does not replay it). The first run of steps (from the intact
    network: the start), the last and ``extra_segments`` others drawn with
    ``rng`` are solved anew; every step of a chosen run is judged. Each
    step's fracture is judged against the reference's strain on the same
    set, which is the stage the step-by-step following skips.

    Returns the worst of each number over the judged steps, each relative
    to the larger of the step's scale and step 1's:

    - ``disp_err``: max |u − u_ref| over max |u_ref|;
    - ``residual``: how far the program's displacements are from solving
      the reference's problem: |K_ff u_f + K_fk u_k| over |K_fk u_k| on the
      nodes the reference frees (``Mesh.residual``, ``Mesh.load``), and
      max |u − prescribed| over max |u_ref| on the others (grips, and
      nodes no active path joins to a grip, at zero), the larger;
    - ``stress_err`` and ``force_err``: the program's stresses and total
      force against those the reference computes from the program's own
      displacements (what ``post_solve`` computes), max |difference| over
      max |reference|;
    - ``fracture_margin``: the largest distance from the threshold, over
      max_strain, of an element whose fracture the program decided
      otherwise than the reference's strain says;
    - ``records_off``: steps whose layout is wrong (a wrong abscissa, an
      element brought back, the records cut before full fracture or not
      at it); and ``steps`` judged."""
    p = mesh.phys
    n_rec = rec.active.shape[0]
    off = 0
    dead = np.nonzero(~rec.active.any(axis=1))[0]
    want = dead[0] + 1 if len(dead) else p.n_steps
    off += int(n_rec != want)
    xs = 2 * dmax * (np.arange(n_rec) / (p.n_steps - 1))
    off += int(np.sum(rec.force_disp[:, 0] != xs))
    segs = segments(rec.active, n_rec)
    for k, (_, _, before) in enumerate(segs):
        last = segs[k + 1][2] if k + 1 < len(segs) else rec.active[-1]
        off += int(np.any(last & ~before))
    pick = {0, len(segs) - 1}
    rest = list(range(1, len(segs) - 1))
    if rest and extra_segments:
        pick |= set(rng.choice(rest, min(extra_segments, len(rest)),
                               replace=False).tolist())
    worst = dict(disp_err=0.0, stress_err=0.0, force_err=0.0,
                 residual=0.0, fracture_margin=0.0)
    scale1 = None
    n_judged = 0
    for i in sorted(pick):
        first, last, before = segs[i]
        unit = mesh.unit_pull(before)
        free = mesh.free(before)
        load1 = mesh.load(before, free, step_dy(dmax, p.n_steps, 1))
        for step in range(first, last + 1):
            dy = step_dy(dmax, p.n_steps, step)
            u = unit * dy
            strain = mesh.strain(u)
            if scale1 is None:     # the first run holds steps 0 and 1
                u1 = unit * step_dy(dmax, p.n_steps, 1)
                s1 = np.where(before, p.e_mod * mesh.strain(u1), 0.0)
                scale1 = (np.abs(u1).max(), np.abs(s1).max(),
                          abs(mesh.force(before, u1)))
            got_u = rec.disp[step].reshape(-1, 3)
            worst["disp_err"] = max(worst["disp_err"], _rel(
                got_u, u, scale1[0]))
            # the stresses and the force the program's own displacements
            # give: what post_solve had to compute from them
            own = np.where(before, p.e_mod * mesh.strain(got_u), 0.0)
            worst["stress_err"] = max(worst["stress_err"], _rel(
                rec.stress[step], own, scale1[1]))
            worst["force_err"] = max(worst["force_err"], _rel(
                rec.force_disp[step, 1], mesh.force(before, got_u),
                scale1[2]))
            load = load1 * max(step, 1)     # linear in dy; step 1's at 0
            pinned = np.abs(got_u - mesh.grips_at(dy))[~free].max(
                initial=0.0) / scale1[0]
            worst["residual"] = max(worst["residual"], pinned, mesh.residual(
                before, free, got_u) / load if load else 0.0)
            ref_new = before & (np.abs(strain) <= p.max_strain)
            differ = ref_new != rec.active[step]
            if differ.any():
                gap = np.abs(np.abs(strain[differ]) - p.max_strain)
                worst["fracture_margin"] = max(
                    worst["fracture_margin"],
                    float(gap.max() / p.max_strain))
            n_judged += 1
    return dict(worst, records_off=off, steps=n_judged)


def _rel(got, ref, floor: float) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    den = max(float(np.abs(ref).max()), floor)
    return float(np.abs(got - ref).max() / den)


def solve_error(unit: np.ndarray, dy: float, x) -> float:
    """A cold solve's max |x − x_ref| over max |x_ref|, x_ref = dy · the
    unit pull's solution of the same network."""
    ref = unit * dy
    return float(np.abs(np.asarray(x, np.float64) - ref).max()
                 / np.abs(ref).max())
