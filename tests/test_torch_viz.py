"""The port's plots (``mycelium_tpu_torch/viz/plots.py``) against the JAX
package's (``mycelium_tpu/viz/plots.py``): each function, given the same
numpy inputs (made from a seed), writes a PNG whose pixels, decoded with
``matplotlib.image.imread``, equal the JAX function's exactly: the growth
frame in 2D and 3D (and with no segment), the FEA frame, the growth
summary, the force-displacement curve and a snapshot CSV."""

import os

import matplotlib.image as mpimg
import numpy as np
import pytest

from mycelium_tpu import viz as jviz
from mycelium_tpu_torch import viz as tviz
from mycelium_tpu_torch.io import write_snapshot_csv


def _segments(rng, n, three_d=False):
    starts = rng.uniform(-2.0, 2.0, (n, 3))
    if not three_d:
        starts[:, 2] = 0.0
    ends = starts + rng.normal(0.0, 0.05, (n, 3)) * (1.0 if three_d else
                                                     np.array([1, 1, 0]))
    return starts, ends


def _history(rng, steps=12):
    rows = []
    for t in range(steps):
        rows.append(dict(step=t, hyphae=25 + 3 * t, segments=25 + 9 * t,
                         active_tips=int(rng.integers(10, 40)),
                         passive_tips=9 * t, anastomosed=t // 2,
                         branches=3 * t,
                         total_length_mm=float(0.05 * (25 + 9 * t))))
    return rows


def _draw(mod, name, case, out):
    """Call ``mod``'s function ``name`` on case ``case`` (a dict of
    numpy inputs) writing into ``out``; returns the PNG's path."""
    if name == "mycelium":
        return mod.plot_mycelium(case["starts"], case["ends"], case["inten"],
                                 7, out, inoculum=case["inoc"],
                                 three_d=case["three_d"], height=0.1)
    if name == "network":
        return mod.plot_network(case["coords"], case["conn"], case["stress"],
                                case["active"], out, 4)
    if name == "summary":
        os.makedirs(out)
        return mod.plot_growth_summary(case["history"], out)
    if name == "force_displacement":
        return mod.plot_force_displacement(case["fd"], out)
    return mod.plot_snapshot_csv(case["csv"], out)


def _case(kind, tmp_path):
    rng = np.random.default_rng(11)
    if kind in ("mycelium_2d", "mycelium_3d", "mycelium_empty"):
        three_d = kind == "mycelium_3d"
        starts, ends = _segments(rng, 0 if kind == "mycelium_empty" else 300,
                                 three_d)
        inoc = np.array([[0.0, 0.0, 0.0], [0.5, -0.5, 0.0]])
        return "mycelium", dict(starts=starts, ends=ends, three_d=three_d,
                                inten=rng.uniform(0, 1e-7, len(starts)),
                                inoc=inoc)
    if kind == "network":
        coords = rng.uniform(-1.5, 1.5, (120, 3)) + np.array([0, 1.5, 0])
        conn = rng.integers(0, 120, (200, 2)).astype(np.int32)
        return "network", dict(coords=coords, conn=conn,
                               stress=rng.uniform(0, 45.0, 200),
                               active=rng.random(200) > 0.2)
    if kind == "summary":
        return "summary", dict(history=_history(rng))
    if kind == "force_displacement":
        d = np.linspace(0, 0.02, 11)
        return "force_displacement", dict(
            fd=np.stack([d, rng.uniform(0, 1e-5, 11)], axis=1))
    starts, ends = _segments(rng, 150)
    csv = write_snapshot_csv(str(tmp_path / "snapshots"), 12, starts, ends,
                             rng.uniform(0, 1e-7, 150))
    return "snapshot_csv", dict(csv=csv)


KINDS = ["mycelium_2d", "mycelium_3d", "mycelium_empty", "network",
         "summary", "force_displacement", "snapshot_csv"]


@pytest.mark.parametrize("kind", KINDS)
def test_plot_pixels_equal_jax(kind, tmp_path):
    name, case = _case(kind, tmp_path)
    paths = []
    for tag, mod in (("port", tviz), ("jax", jviz)):
        out = str(tmp_path / tag if name == "summary"
                  else tmp_path / tag / "frame.png")
        paths.append(_draw(mod, name, case, out))
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    port, ref = (mpimg.imread(p) for p in paths)
    assert port.shape == ref.shape and port.shape[0] > 300
    np.testing.assert_array_equal(port, ref)
    assert port.std() > 0            # something was drawn
