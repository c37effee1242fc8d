"""The compact probe and fanout_mean CUDA kernels against their twins on
the card (every test is ``cuda``-marked and skips without one).

This file imports no jax, so it also runs where only torch is installed:
``python -m pytest -m cuda tests/test_torch_kernels_card.py`` on the card's
machine.  The twins are held against ``repro`` on the CPU by
``tests/test_torch_kernels.py``, on the same edge cases
(``_torch_parity.compact_edge``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (COMPACT_EDGES, compact_edge,  # noqa: E402
                           probe_cache, resident_absent)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cache_gather import compact_plan  # noqa: E402
from repro_torch.kernels.gather_reduce import fanout_mean_plan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _compact_equal(keys, rows, ids, assoc, hit_cap):
    """One launch of the compact kernel, exactly equal to its twin."""
    ops.reset_launch_counts()
    got = ops.cache_probe_compact(keys, rows, ids, assoc=assoc,
                                  hit_cap=hit_cap)
    assert ops.launch_counts()["cache_probe_compact"] == 1
    want = ref.cache_probe_compact_ref(keys, rows, ids, assoc=assoc,
                                       hit_cap=hit_cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("d,dtype", [(8, torch.float32),      # 16-byte route
                                     (8, torch.bfloat16),     # 16-byte route
                                     (130, torch.float32)])   # scalar route
@pytest.mark.parametrize("case", COMPACT_EDGES)
def test_cache_probe_compact_edges_on_card(cuda, case, d, dtype):
    """The launch plan's edges (``compact_edge``), both row routes."""
    keys, rows, ids, hit_cap = compact_edge(case, d=d)
    _compact_equal(torch.from_numpy(keys[None]).to(cuda),
                   torch.from_numpy(rows[None]).to(cuda, dtype),
                   torch.from_numpy(ids[None]).to(cuda), 2, hit_cap)


@pytest.mark.parametrize("h,w,r", [(4, 4, 13464), (4, 4, 6736), (8, 8, 1000),
                                   (1, 2, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_probe_compact_rounds_on_card(cuda, h, w, r, dtype):
    """The W = 4 serve round ([4, 4, 13 464], hit_cap 6 732, D 128) and
    train round ([4, 4, 6 736], hit_cap 842), and clusters of 3 (W = 8 and
    a 3-word row), with every destination row at another hit share (some
    demoted, some with a zero tail)."""
    c, d = (4096, 128) if h == 4 else (64, 16)
    caches = [probe_cache(c, d, 4, 100 + i) for i in range(h)]
    ids = np.empty((h, w, r), np.int32)
    for i, (keys, _, _, rng) in enumerate(caches):
        resident, absent = resident_absent(keys)
        for j in range(w):
            share = (0.1, 0.3, 0.55, 0.8)[j % 4]
            ids[i, j] = np.where(rng.random(r) < share,
                                 rng.choice(resident, size=r),
                                 rng.choice(absent, size=r))
        ids[i][rng.random((w, r)) < 0.05] = -1
    hit_cap = {13464: 6732, 6736: 842}.get(r, r // 3)
    if h * w == 64 or r == 77:
        assert compact_plan(h, w, r, c).cluster == 3
    _compact_equal(torch.from_numpy(np.stack([k for k, *_ in caches])).to(cuda),
                   torch.from_numpy(np.stack([x for _, x, *_ in caches])).to(
                       cuda, dtype),
                   torch.from_numpy(ids).to(cuda), 4, hit_cap)


def test_cache_probe_compact_refusals_on_card(cuda):
    """Too many keys per holder for shared memory, and a 16-byte-route row
    base off 16-byte alignment, raise ValueError (no fallback)."""
    ids = torch.zeros((1, 1, 32), dtype=torch.int32, device=cuda)
    keys = torch.full((1, 1 << 16), -1, dtype=torch.int32, device=cuda)
    rows = torch.zeros((1, 1 << 16, 4), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.cache_probe_compact(keys, rows, ids, assoc=1, hit_cap=4)
    keys = keys[:, :64].contiguous()
    rows = torch.zeros(64 * 8 + 1, device=cuda)[1:].view(1, 64, 8)
    with pytest.raises(ValueError, match="aligned"):
        ops.cache_probe_compact(keys, rows, ids, assoc=1, hit_cap=4)


@pytest.mark.parametrize("m,k,d,dtype", [
    (5120, 20, 128, torch.float32), (128, 40, 128, torch.float32),
    (128, 40, 256, torch.float32),                  # the W = 4 request
    (481, 10, 128, torch.float32),                  # M off the CTA's rows
    (37, 9, 130, torch.float32), (37, 9, 130, torch.bfloat16),   # scalar
    (5120, 20, 128, torch.bfloat16), (3, 1100, 3, torch.float32)])
def test_fanout_mean_shapes_on_card(cuda, m, k, d, dtype):
    """fanout_mean against its twin with all-masked rows (exact zeros):
    float32 within rtol 1e-5 / atol 1e-6 (summation order), bfloat16
    within 2e-2 / 2e-3 (both round one float32 mean once)."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k, d), generator=g, device=cuda).to(dtype)
    mask = torch.rand((m, k), generator=g, device=cuda) < 0.7
    mask[:3] = False
    plan = fanout_mean_plan(m, k, d, x.element_size())
    assert m % plan.rows or m != 481
    ops.reset_launch_counts()
    got = ops.fanout_mean(x, mask)
    assert ops.launch_counts()["fanout_mean"] == 1
    want = ref.fanout_mean_ref(x, mask)
    tol = (1e-5, 1e-6) if dtype == torch.float32 else (2e-2, 2e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    assert got.dtype == dtype and not got[:3].any()


def test_fanout_mean_misaligned_base_on_card(cuda):
    """A float32 x whose base is off 16-byte alignment takes the scalar
    instance of the kernel and agrees with its twin."""
    flat = torch.randn(128 * 40 * 128 + 1, device=cuda)
    x = flat[1:].view(128, 40, 128)
    mask = torch.rand((128, 40), device=cuda) < 0.7
    assert fanout_mean_plan(128, 40, 128, 4,
                            aligned=x.data_ptr() % 16 == 0).vec == 1
    torch.testing.assert_close(ops.fanout_mean(x, mask),
                               ref.fanout_mean_ref(x, mask), rtol=1e-5,
                               atol=1e-6)
