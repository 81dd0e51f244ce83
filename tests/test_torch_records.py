"""The records of the device-resident pull test (``fea/ramp.py``:
``_device_result``, ``_fetch_records``): on the card the three record
buffers are copied into page-locked host tensors of the result's own, on
the CPU they are taken as ``.cpu()`` gives them.

On both devices: two pull tests in turn on one model share no memory and
the second leaves the first's records as they were; the records equal the
``.cpu()`` fetch of the same device buffers bit for bit, for a test that
ran every step and for one that stopped early on full fracture. On the
CPU the fetch asks for no page-locked memory and counts nothing of it
under a profiler. On the card each record is page-locked, five tests after
a warm-up page-lock no new host memory, and under a profiler
``fea.records.pinned_bytes`` is the records' bytes and
``fea.records.pinned_fresh`` 0. The card's cases skip without one. The
file imports no jax, so it runs on a machine with PyTorch for CUDA and no
jax:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_records.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mycelium_tpu_torch.config import hybrid_fea_config
from mycelium_tpu_torch.fea import build_model, ramp, run_ramp_async
from mycelium_tpu_torch.meshes import synthetic_mesh
from mycelium_tpu_torch.utils import profiling
# imported by its own name (pytest puts tests/ on sys.path): a machine
# with an unrelated installed package named "tests" shadows tests.*
from torch_support import cuda_device  # noqa: F401  (one torch thread)

RECORDS = ("stress_record", "active_record", "disp_record")
ALL_RECORDS = RECORDS + ("force_disp", "cg_iters")


def _fracture_case():
    """A 1,500-node network pulled to 0.06 mm: elements fracture, and
    every one of the 40 steps runs."""
    coords, conn = synthetic_mesh(1500, seed=0)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return coords, conn, hybrid_fea_config(displacement_max=0.06,
                                           grip_length=0.3 * ext)


def _early_stop_case():
    """Five bars of two elements between the grips: both elements of a bar
    strain alike, so every element fractures at one step and the test stops
    at its next status read, before step 40."""
    coords, conn = [], []
    for i in range(5):
        b = len(coords)
        coords += [[0.1 * i, 0.0, 0.0], [0.1 * i, 0.5, 0.0],
                   [0.1 * i, 1.0, 0.0]]
        conn += [[b, b + 1], [b + 1, b + 2]]
    return (np.asarray(coords), np.asarray(conn, np.int32),
            hybrid_fea_config(displacement_max=0.02, grip_length=0.3))


CASES = {"fracture": _fracture_case, "early stop": _early_stop_case}
_MODELS = {}


def _case(name: str, device):
    """(coords, conn, configuration, model) of case ``name`` on
    ``device``, the model built once a process."""
    key = (name, str(device))
    if key not in _MODELS:
        coords, conn, cfg = CASES[name]()
        _MODELS[key] = (coords, conn, cfg,
                        build_model(coords, conn, cfg, device))
    return _MODELS[key]


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory is the card's")
    return torch.device(request.param)


def test_results_own_their_records(device):
    coords, conn, cfg, m = _case("fracture", device)
    first = run_ramp_async(coords, conn, cfg, model=m)
    kept = {f: getattr(first, f).copy() for f in ALL_RECORDS}
    second = run_ramp_async(coords, conn, cfg, model=m)
    assert not first.active_record[-1].all(), "nothing fractured"
    for f in ALL_RECORDS:
        assert not np.shares_memory(getattr(first, f), getattr(second, f)), f
        np.testing.assert_array_equal(getattr(first, f), kept[f], err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_equal_the_pageable_fetch(device, case):
    """``_device_result``'s records against the parent's fetch,
    ``b[:done].cpu()``, of the same device buffers: bit for bit."""
    coords, conn, cfg, m = _case(case, device)
    bufs = ramp._device_ramp(m, cfg, 8, True)
    stress_b, active_b, disp_b, status, _, done = bufs
    assert (done < cfg.n_steps) == (case == "early stop"), done
    res = ramp._device_result(m, cfg, bufs, 0.0)
    for f, b in zip(RECORDS, (stress_b, active_b, disp_b)):
        want = b[:done].cpu().numpy()
        got = getattr(res, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(res.force_disp[:, 1], status[:done, 3])
    np.testing.assert_array_equal(res.cg_iters, status[:done, 2])


def test_cpu_fetch_asks_for_no_page_locked_memory(monkeypatch):
    """A CPU model's fetch allocates nothing page-locked, reads no host
    allocator statistics (there is no card) and, under a profiler, counts
    no pinned bytes; its one fetch span stays."""
    coords, conn, cfg, m = _case("fracture", torch.device("cpu"))
    empty = torch.empty

    def no_pinned_empty(*args, pin_memory=False, **kw):
        assert not pin_memory, "page-locked memory asked for on the CPU"
        return empty(*args, **kw)

    def no_stats():
        raise AssertionError("host allocator statistics read on the CPU")

    monkeypatch.setattr(torch, "empty", no_pinned_empty)
    monkeypatch.setattr(ramp, "_pinned_blocks", no_stats)
    profiling.reset_readings()
    with profile(activities=[ProfilerActivity.CPU]):
        res = run_ramp_async(coords, conn, cfg, model=m)
    got = profiling.readings()
    profiling.reset_readings()
    assert got["fea.records.fetch"]["count"] == 1
    assert not [n for n in got if n.startswith("fea.records.pinned")]
    for f in RECORDS:
        assert not torch.from_numpy(getattr(res, f)).is_pinned(), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_records_are_page_locked(cuda_device, case):  # noqa: F811
    coords, conn, cfg, m = _case(case, cuda_device)
    res = run_ramp_async(coords, conn, cfg, model=m)
    for f in RECORDS:
        assert torch.from_numpy(getattr(res, f)).is_pinned(), f


def test_card_warm_fetches_page_lock_nothing_new(cuda_device):  # noqa: F811
    """Once a test of a size has been fetched and dropped, five more take
    their page-locked blocks from the host allocator's cache."""
    coords, conn, cfg, m = _case("fracture", cuda_device)
    run_ramp_async(coords, conn, cfg, model=m)
    before = ramp._pinned_blocks()
    for _ in range(5):
        run_ramp_async(coords, conn, cfg, model=m)
    assert ramp._pinned_blocks() == before


def test_card_pinned_counters(cuda_device):  # noqa: F811
    coords, conn, cfg, m = _case("fracture", cuda_device)
    run_ramp_async(coords, conn, cfg, model=m)
    profiling.reset_readings()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = run_ramp_async(coords, conn, cfg, model=m)
    got = profiling.readings()
    profiling.reset_readings()
    assert len(res.active_record) == cfg.n_steps, "the records were cut"
    assert got["fea.records.pinned_bytes"] == sum(
        getattr(res, f).nbytes for f in RECORDS)
    assert got["fea.records.pinned_fresh"] == 0
    assert got["fea.records.fetch"]["count"] == 1
