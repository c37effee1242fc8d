"""The compact probe, fanout_mean, fanout_mean_bwd and tiered probe CUDA
kernels against their twins on the card (every test is ``cuda``-marked and
skips without one).

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
                           probe_cache, resident_absent, tiered_blocks)
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


def _same(got, want):
    """Equal dtype, shape and values, nan where the twin has nan (the
    card's nan payload may differ from the CPU's), and equal signs (a
    masked negative gradient is -0.0 in both)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert torch.equal(torch.signbit(got[~nan]), torch.signbit(want[~nan]))


def _bwd_once(g, mask):
    """One launch of the backward kernel, equal to its twin."""
    ops.reset_launch_counts()
    got = ops.fanout_mean_bwd(g, mask)
    assert ops.launch_counts()["fanout_mean_bwd"] == 1
    _same(got, ref.fanout_mean_bwd_ref(g, mask))
    return got


@pytest.mark.parametrize("m,k,d,dtype", [
    (32, 15, 256, torch.float32), (480, 10, 256, torch.float32),
    (128, 40, 256, torch.float32),                  # the train steps' shapes
    (480, 10, 256, torch.bfloat16), (32, 15, 256, torch.bfloat16),
    (1, 1, 256, torch.float32),                     # M = 1, K = 1
    (3, 33, 128, torch.float32), (5, 64, 8, torch.bfloat16),  # K > 32
    (37, 9, 130, torch.float32), (37, 9, 130, torch.bfloat16),
    (5, 1100, 3, torch.float32)])                   # D off 32, K > 1024
def test_fanout_mean_bwd_shapes_on_card(cuda, m, k, d, dtype):
    """The backward against its twin, exactly, at rows of every width (a
    part-filled warp where D is off a multiple of 32), with an all-masked
    row."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + d)
    g = torch.randn((m, d), generator=gen, device=cuda).to(dtype)
    mask = torch.rand((m, k), generator=gen, device=cuda) < 0.7
    if m > 1:
        mask[1] = False
    got = _bwd_once(g, mask)
    if m > 1:
        assert not got[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fanout_mean_bwd_misaligned_and_nonfinite_on_card(cuda, dtype):
    """A gradient whose base is off 16-byte alignment (a sliced view) and an
    aligned copy; inf, -inf and nan in g propagate as in the twin (q * 0 is
    nan where the mask is off), negative values give -0.0."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    flat = torch.randn(480 * 256 + 1, generator=gen, device=cuda).to(dtype)
    g = flat[1:].view(480, 256)
    assert g.data_ptr() % 16
    mask = torch.rand((480, 10), generator=gen, device=cuda) < 0.7
    mask[2] = False
    g[0, :3] = torch.tensor([float("inf"), -float("inf"), float("nan")],
                            device=cuda, dtype=dtype)
    g[2, :3] = g[0, :3]
    got = _bwd_once(g, mask)
    assert got[2, :, :3].isnan().all()
    _bwd_once(g.contiguous().clone(), mask)         # an aligned base


@pytest.mark.parametrize("c1,a1,c2,a2,r,d,dtype", [
    (512, 2, 4096, 4, 29312, 128, torch.float32),  # the deep step's shape
    (512, 2, 4096, 4, 29312, 128, torch.bfloat16),
    (512, 2, 4096, 4, 1, 128, torch.float32),      # R = 1
    (512, 2, 4096, 4, 77, 130, torch.float32),     # scalar rows, R % 32
    (16, 1, 64, 1, 77, 40, torch.float32),         # other associativities
    (16, 2, 64, 2, 96, 130, torch.bfloat16),
    (16, 4, 64, 1, 33, 8, torch.float32),
    (2, 2, 64, 4, 50, 8, torch.float32),           # single-set L1
    (8, 1, 4, 4, 41, 8, torch.bfloat16),           # single-set L2
    (4, 4, 4, 4, 33, 8, torch.float32)])           # both single-set
@pytest.mark.parametrize("minus_one_slot", [False, True])
def test_cache_probe_tiered_edges_on_card(cuda, c1, a1, c2, a2, r, d, dtype,
                                          minus_one_slot):
    """The tiered probe against its twin, exactly, in one launch: the deep
    config's 2-way L1 before a 4-way L2 and other associativities, both
    row routes (16-byte units and the scalar instance), single-set tiers,
    R = 1 and R off a multiple of 32, double hits (the L1 wins), misses,
    and -1 ids, which match an empty slot of their set where one is."""
    k1, r1, k2, r2, pool, rng = tiered_blocks(c1, a1, c2, a2, d, c1 + r + d,
                                              minus_one_slot)
    ids = np.where(rng.random(r) < 0.7, rng.choice(pool, size=r),
                   rng.integers(0, 10 * c2, r)).astype(np.int32)
    ids[rng.random(r) < 0.1] = -1
    args = [torch.from_numpy(a).to(cuda) for a in (k1, r1, k2, r2, ids)]
    args[1], args[3] = args[1].to(dtype), args[3].to(dtype)
    ops.reset_launch_counts()
    got = ops.cache_probe_tiered(*args, l1_assoc=a1, l2_assoc=a2)
    assert ops.launch_counts()["cache_probe_tiered"] == 1
    want = ref.cache_probe_tiered_ref(*args, l1_assoc=a1, l2_assoc=a2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if minus_one_slot and (ids == -1).any():
        assert (got[0][torch.from_numpy(ids).to(cuda) == -1] == 1).all()


def test_cache_probe_tiered_misaligned_on_card(cuda):
    """Rows and keys off 16-byte alignment (sliced views): the rows take the
    scalar row route, and the probe agrees with the twin exactly."""
    k1, r1, k2, r2, _, rng = tiered_blocks(512, 2, 4096, 4, 128, 5)
    ids = rng.choice(np.concatenate([k1[k1 >= 0], k2[k2 >= 0]]),
                     size=1000).astype(np.int32)

    def shifted(a, dtype=None):
        t = torch.from_numpy(a).to(cuda, dtype)
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    args = [shifted(k1), shifted(r1), shifted(k2), shifted(r2),
            torch.from_numpy(ids).to(cuda)]
    assert args[0].data_ptr() % 8 and args[1].data_ptr() % 16
    ops.reset_launch_counts()
    got = ops.cache_probe_tiered(*args, l1_assoc=2, l2_assoc=4)
    assert ops.launch_counts()["cache_probe_tiered"] == 1
    for a, b in zip(got, ref.cache_probe_tiered_ref(*args, l1_assoc=2,
                                                    l2_assoc=4)):
        assert torch.equal(a, b)
    assert (got[0] > 0).all()


def test_gcn_deep_backward_card_vs_cpu(cuda):
    """graphgen-gcn-deep at full width (fanouts 15, 10, 5; 128 -> 256) on
    one random batch of 32 seeds: the card's loss and every parameter
    gradient within rtol 1e-4 / atol 1e-6 of the CPU port's (float32
    reduction order, the bound of the train tests), through three backward
    launches (level 0 twice, level 1 once)."""
    from repro_torch.configs import get_config
    from repro_torch.graph.subgraph import SubgraphBatch
    from repro_torch.models.gcn import gcn_loss, init_gcn
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("graphgen-gcn-deep")
    rng = np.random.default_rng(12)
    b, d = 32, cfg.gcn_in_dim
    masks, shape, parent = [], (b,), None
    for k in cfg.fanouts:
        shape = shape + (k,)
        m = rng.random(shape) < 0.75
        if parent is not None:
            m &= parent[..., None]
        masks.append(m)
        parent = m
    fields = dict(
        seeds=np.arange(b, dtype=np.int32),
        hops=tuple(np.zeros(m.shape, np.int32) for m in masks),
        masks=tuple(masks),
        x_seed=rng.standard_normal((b, d)).astype(np.float32),
        x_hops=tuple((rng.standard_normal(m.shape + (d,)) * m[..., None])
                     .astype(np.float32) for m in masks),
        labels=rng.integers(0, cfg.n_classes, b).astype(np.int32),
        n_dropped=np.zeros(1, np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        batch = SubgraphBatch(**{
            k: tuple(torch.from_numpy(a).to(dev) for a in v)
            if isinstance(v, tuple) else torch.from_numpy(v).to(dev)
            for k, v in fields.items()})
        model = init_gcn(cfg, 3, device=dev)
        ops.reset_launch_counts()
        loss = gcn_loss(model, batch)
        grads = torch.autograd.grad(loss, model.leaves())
        out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads],
                    ops.launch_counts()["fanout_mean_bwd"])
    (lc, gc, _), (lg, gg, n_bwd) = out["cpu"], out["cuda"]
    assert n_bwd == 3
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
