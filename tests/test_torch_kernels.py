"""The port's kernels against the reference.

On the CPU: each plain-torch twin (``repro_torch.kernels.ref``, which
``ops`` dispatches CPU tensors to) against both ``repro``'s jnp oracle and
its Pallas kernel run in interpret mode — probes exact, fanout_mean within
rtol 1e-5 / atol 1e-6 in float32 (the sum is taken in another order) —
and fanout_mean's backward against ``jax.grad`` of the oracle.  The
gather_reduce twin is held to the jnp oracle only: its Pallas kernel does
not run under this jax (no ``pl.load``).

On a card (marked ``cuda``, skipped elsewhere): each CUDA kernel against
its twin on the same CUDA inputs.  ``chip_smoke.py`` repeats that check at
the serving shapes.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (COMPACT_EDGES, as_u32, compact_edge,  # noqa: E402
                           compact_word_ranges, probe_cache)
from repro.core.feature_cache import hash_slots as jhash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, cache_gather, ops, ref  # noqa: E402
from repro_torch.kernels.cache_gather import (  # noqa: E402
    MAX_CLUSTER, SMEM_LIMIT, TIERED_IDS, TIERED_WARPS, compact_plan,
    tiered_plan)
from repro_torch.kernels.gather_reduce import (  # noqa: E402
    BWD_WARPS, FANOUT_SMEM_LIMIT, FANOUT_THREADS, GATHER_UNROLL, GATHER_WARPS,
    fanout_mean_bwd_plan, fanout_mean_plan, gather_reduce_plan)


@pytest.mark.parametrize("m,k,d", [(8, 4, 16), (37, 9, 130), (5, 40, 64)])
def test_fanout_mean_twin(m, k, d):
    """float32 fanout_mean twin vs the jnp oracle and the Pallas kernel."""
    rng = np.random.default_rng(m * k)
    x = rng.standard_normal((m, k, d)).astype(np.float32)
    mask = rng.random((m, k)) < 0.6
    mask[0] = False                      # an all-padding row divides by 1
    got = ops.fanout_mean(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    for want in (jref.fanout_mean_ref(jnp.asarray(x), jnp.asarray(mask)),
                 jops.fanout_mean(jnp.asarray(x), jnp.asarray(mask),
                                  use_kernel=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,m,k", [(100, 64, 13, 5), (257, 96, 8, 40),
                                     (64, 128, 32, 20)])
def test_gather_reduce_twin(n, d, m, k, dtype):
    """gather_reduce twin vs the jnp oracle ``repro.kernels.ref.
    gather_reduce_ref``: ids out of range on both sides (clamped), rows
    with every slot masked off (mean 0), float32 within rtol 1e-5 / atol
    1e-6 (summation order); bfloat16 within 2e-2 (the oracle sums and
    divides in bf16, the twin rounds one float32 mean once)."""
    rng = np.random.default_rng(n + m)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(-7, n + 7, (m, k)).astype(np.int32)
    idx[0, 0], idx[0, 1] = -1, n            # clamp to the first/last row
    mask = rng.random((m, k)) < 0.8
    mask[1:3] = False                       # all-padding rows divide by 1
    mask[0, :2] = True
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    got = ops.gather_reduce(torch.from_numpy(table).to(tdt),
                            torch.from_numpy(idx), torch.from_numpy(mask))
    want = jref.gather_reduce_ref(jnp.asarray(table).astype(jdt),
                                  jnp.asarray(idx), jnp.asarray(mask))
    assert got.dtype == tdt and got.shape == (m, d)
    tol = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])
    assert (got[1:3] == 0).all()


@pytest.mark.parametrize("c,d,r,assoc", [(64, 16, 17, 1), (256, 32, 300, 2),
                                          (256, 32, 300, 4)])
def test_cache_probe_gather_twin(c, d, r, assoc):
    """Probe twin vs the oracle and the Pallas kernel, exactly — resident
    ids, misses, and -1 ids (which the oracle lets match empty slots)."""
    keys, rows, pool, rng = probe_cache(c, d, assoc, c + r + assoc)
    ids = np.where(rng.random(r) < 0.5, rng.choice(pool, size=r),
                   rng.integers(0, 10 * c, r)).astype(np.int32)
    ids[rng.random(r) < 0.1] = -1
    hit, out = ops.cache_probe_gather(torch.from_numpy(keys),
                                      torch.from_numpy(rows),
                                      torch.from_numpy(ids), assoc=assoc)
    args = (jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(ids))
    for use_kernel in (False, True):
        wh, wo = jops.cache_probe_gather(*args, assoc=assoc,
                                         use_kernel=use_kernel)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(out.numpy(), np.asarray(wo))


def test_cache_probe_gather_single_set():
    """c == assoc -> one set: every id hashes to set 0."""
    keys = np.asarray([11, 22, -1, 33], np.int32)
    rows = np.arange(8, dtype=np.float32).reshape(4, 2)
    ids = np.asarray([22, 5, 33, 11, -7], np.int32)
    hit, out = ops.cache_probe_gather(torch.from_numpy(keys),
                                      torch.from_numpy(rows),
                                      torch.from_numpy(ids), assoc=4)
    wh, wo = jref.cache_probe_gather_ref(jnp.asarray(keys), jnp.asarray(rows),
                                         jnp.asarray(ids), assoc=4)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(out.numpy(), np.asarray(wo))


@pytest.mark.parametrize("c,d,w,r,assoc", [(64, 16, 4, 33, 1),
                                            (256, 8, 2, 300, 4)])
@pytest.mark.parametrize("hit_cap", [1, 16, 4096])
def test_cache_probe_compact_twin(c, d, w, r, assoc, hit_cap):
    """Compact probe twin (one holder on the stacked axis) vs the oracle
    and the Pallas kernel: identical bitmap words (as uint32) and payload,
    with heavy demotion (hit_cap 1) and none (4096, clamped to R)."""
    keys, rows, pool, rng = probe_cache(c, d, assoc, c + r + assoc)
    ids = np.where(rng.random((w, r)) < 0.5, rng.choice(pool, size=(w, r)),
                   rng.integers(0, 10 * c, (w, r))).astype(np.int32)
    ids[rng.random((w, r)) < 0.15] = -1
    got = [t[0] for t in ops.cache_probe_compact(
        torch.from_numpy(keys[None]), torch.from_numpy(rows[None]),
        torch.from_numpy(ids[None]), assoc=assoc, hit_cap=hit_cap)]
    args = (jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(ids))
    for use_kernel in (False, True):
        want = jops.cache_probe_compact(*args, assoc=assoc, hit_cap=hit_cap,
                                        use_kernel=use_kernel)
        np.testing.assert_array_equal(as_u32(got[0]), as_u32(want[0]))
        np.testing.assert_array_equal(as_u32(got[1]), as_u32(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_cache_probe_compact_stacked_holders():
    """The holder axis probes each holder's cache with its own ids — the
    same as one call per holder."""
    c, d, w, r = 64, 4, 3, 40
    parts = [probe_cache(c, d, 2, s) for s in (1, 2)]
    keys = torch.from_numpy(np.stack([p[0] for p in parts]))
    rows = torch.from_numpy(np.stack([p[1] for p in parts]))
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(np.stack([
        rng.choice(np.concatenate([p[2], [-1, 5]]), size=(w, r))
        for p in parts]).astype(np.int32))
    stacked = ops.cache_probe_compact(keys, rows, ids, assoc=2, hit_cap=9)
    for h in range(2):
        single = ops.cache_probe_compact(keys[h:h + 1], rows[h:h + 1],
                                         ids[h:h + 1], assoc=2, hit_cap=9)
        for a, b in zip(stacked, single):
            assert torch.equal(a[h], b[0])


@pytest.mark.parametrize("case", COMPACT_EDGES)
def test_cache_probe_compact_plan_edges(case):
    """Compact probe twin vs the oracle and the Pallas kernel (interpret)
    on the edges of the CUDA kernel's launch plan (``compact_edge``): R
    off a multiple of 32 x S, hit_cap on a cluster rank's boundary, hits
    only in the last rank owning words, all misses, all -1, hit_cap = R."""
    keys, rows, ids, hit_cap = compact_edge(case)
    got = [t[0] for t in ops.cache_probe_compact(
        torch.from_numpy(keys[None]), torch.from_numpy(rows[None]),
        torch.from_numpy(ids[None]), assoc=2, hit_cap=hit_cap)]
    args = (jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(ids))
    for use_kernel in (False, True):
        want = jops.cache_probe_compact(*args, assoc=2, hit_cap=hit_cap,
                                        use_kernel=use_kernel)
        np.testing.assert_array_equal(as_u32(got[0]), as_u32(want[0]))
        np.testing.assert_array_equal(as_u32(got[1]), as_u32(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    kept = np.unpackbits(as_u32(got[0]).view(np.uint8)).reshape(3, -1).sum(1)
    raw = np.unpackbits(as_u32(got[1]).view(np.uint8)).reshape(3, -1).sum(1)
    if case == "cap_on_boundary":     # demotion starts at rank 1's words
        assert (kept == hit_cap).all() and (raw > hit_cap).all()
    elif case in ("all_miss", "all_minus_one"):
        assert raw.sum() == 0 and not got[2].any()
    elif case == "cap_is_r":
        assert (kept == raw).all() and got[2].shape[1] == 333
    else:
        assert (raw > kept).all()     # hits demoted in every row


@pytest.mark.parametrize("h,w,r,c", [
    (4, 4, 13464, 4096),    # the W = 4 serve round
    (4, 4, 6736, 4096),     # the W = 4 train round
    (1, 3, 333, 256), (1, 2, 77, 4), (1, 1, 1, 4), (8, 8, 1000, 64),
    (132, 1, 32, 16), (2, 64, 40000, 4096), (1, 1, 2048, 1 << 15)])
def test_compact_plan_partitions_words(h, w, r, c):
    """The compact probe's launch plan: S <= 8 ranks whose word ranges
    partition [0, n_words) in order, shared memory as the kernel lays it
    out, and one 128-CTA wave at the W = 4 rounds."""
    plan = compact_plan(h, w, r, c)
    n_words = -(-r // 32)
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.cluster <= -(-132 // (h * w)) and plan.cluster <= n_words
    ranges = compact_word_ranges(plan, n_words)
    assert len(ranges) == plan.cluster and ranges[0][0] == 0
    assert ranges[-1][1] == n_words
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(n_words, 0)]):
        assert lo <= hi == nlo and hi - lo <= plan.words_per_cta
    assert ranges[0][1] - ranges[0][0] == plan.words_per_cta
    assert plan.smem == 4 * (c + 66 * plan.words_per_cta)
    if (h, w) == (4, 4):
        assert plan.cluster == 8 and h * w * plan.cluster == 128
    if c == 1 << 15:    # 128 KB of keys and a 2 048-slot row still fit
        assert plan.smem <= SMEM_LIMIT
    assert compact_plan(1, 1, 32, 1 << 16).smem > SMEM_LIMIT


@pytest.mark.parametrize("m,k,d,elem", [
    (5120, 20, 128, 4), (128, 40, 128, 4), (128, 40, 256, 4),   # W = 4
    (32, 15, 256, 4), (480, 10, 128, 4), (4800, 5, 128, 4),     # deep
    (37, 9, 130, 4), (37, 9, 130, 2), (5120, 20, 128, 2), (1, 1, 1, 4),
    (3, 1100, 3, 4), (481, 10, 128, 4), (5, 0, 64, 4)])
def test_fanout_mean_plan_covers_every_k(m, k, d, elem):
    """The fanout_mean launch plan: a 256-thread CTA, every k of a row in
    exactly one thread group's share, the grid covering M and D, 16-byte
    loads exactly where a row is a 16-byte multiple, ~2 CTAs per SM at the
    W = 4 request's M = 128 shapes; and the masked mean summed in the
    plan's order (each share in k order, the shares in group order)
    agrees with the oracle within rtol 1e-5 / atol 1e-6."""
    plan = fanout_mean_plan(m, k, d, elem)
    assert plan.lanes * plan.ways * plan.rows == FANOUT_THREADS
    assert plan.vec == (16 // elem if (d * elem) % 16 == 0 else 1)
    assert fanout_mean_plan(m, k, d, elem, aligned=False).vec == 1
    # thread group `way` of a row adds k = way, way + ways, ... (the kernel)
    split = [range(way, k, plan.ways) for way in range(plan.ways)]
    assert sorted(j for share in split for j in share) == list(range(k))
    row_vecs = d // plan.vec
    assert plan.grid[0] * plan.rows >= m > (plan.grid[0] - 1) * plan.rows
    assert plan.grid[1] * plan.lanes >= row_vecs
    assert (plan.grid[1] - 1) * plan.lanes < row_vecs
    if m == 128:
        assert plan.grid[0] * plan.grid[1] >= 256
    rng = np.random.default_rng(m + k + d)
    x = rng.standard_normal((m, k, d)).astype(np.float32)
    mask = rng.random((m, k)) < 0.6
    mask[0] = False
    xm = torch.from_numpy(x * mask[..., None])
    acc = torch.zeros((m, d))
    for share in split:
        part = torch.zeros((m, d))
        for j in share:
            part = part + xm[:, j]
        acc = acc + part
    got = acc / torch.from_numpy(mask.sum(1, dtype=np.float32)).clamp(
        min=1)[:, None]
    want = jref.fanout_mean_ref(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _gather_walk(plan, mask, row_vecs):
    """``gather_reduce.cu``'s walk of ``plan`` over ``mask [M, K]``: warp
    (way, r) of CTA (x, y) takes row x * rows + r and K share way, in
    passes of 32 slots; slot group g of the warp takes the pass's slots g,
    g + groups, ... and reads the kept ones, lane l of the group loading
    unit y * lanes + l where it is below ``row_vecs``.  Returns ``seen [M,
    K, units]``, the times each (row, slot, load unit) is read, and per
    row the (share, group, slot) order in which the kernel adds the
    slots."""
    m, k = mask.shape
    groups = 32 // plan.lanes
    share = -(-k // plan.ways)
    seen = np.zeros((m, k, plan.grid[1] * plan.lanes), np.int64)
    order = [[] for _ in range(m)]
    for x in range(plan.grid[0]):
        for r in range(plan.rows):
            row = x * plan.rows + r
            if row >= m:
                continue
            for way in range(plan.ways):
                k_lo, k_hi = way * share, min(k, (way + 1) * share)
                for s0 in range(k_lo, k_hi, 32):
                    n_pos = min(32, k_hi - s0)
                    for g in range(groups):
                        for j in range(g, n_pos, groups):
                            if mask[row, s0 + j]:
                                seen[row, s0 + j, :row_vecs] += 1
                                order[row].append((way, g, s0 + j))
    return seen, order


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("elem,aligned", [(4, True), (2, True), (4, False)])
@pytest.mark.parametrize("k", [1, 5, 20, 33, 40, 64])
@pytest.mark.parametrize("d", [8, 100, 128, 256])
def test_gather_reduce_plan_covers_every_unit(d, k, elem, aligned, n_sm):
    """The gather_reduce launch plan, walked as ``gather_reduce.cu`` walks
    it (``_gather_walk``), over a mask with dropped slots, an all-masked
    row and an all-kept row: every kept (row, slot, load unit) is read
    exactly once, no masked slot and no unit past the row is read; 16-byte
    loads (float32, bfloat16) exactly where the row is a 16-byte multiple
    on an aligned base, else the scalar route; CTAs of at most
    ``GATHER_WARPS`` warps within the device's grid; shared memory under
    ``FANOUT_SMEM_LIMIT``, the most a launch may take without opting in
    (132 SMs: the H100 SXM; 114: the PCIe card)."""
    m = 37
    plan = gather_reduce_plan(m, k, d, elem, aligned=aligned, n_sm=n_sm)
    vec = 16 // elem if aligned and (d * elem) % 16 == 0 else 1
    row_vecs = d // vec
    assert plan.vec == vec and plan.lanes & (plan.lanes - 1) == 0
    assert min(row_vecs, 32) <= plan.lanes <= 32
    assert 1 <= plan.ways <= min(k, GATHER_WARPS)
    assert 1 <= plan.rows and plan.rows * plan.ways <= GATHER_WARPS
    assert plan.grid[0] * plan.rows >= m > (plan.grid[0] - 1) * plan.rows
    assert plan.grid[1] * plan.lanes >= row_vecs
    assert (plan.grid[1] - 1) * plan.lanes < row_vecs <= 65535 * plan.lanes
    assert plan.smem == 4 * plan.rows * plan.ways * 32 * vec
    assert plan.smem <= FANOUT_SMEM_LIMIT
    rng = np.random.default_rng(d + k)
    mask = rng.random((m, k)) < 0.7
    mask[0], mask[1] = True, False
    seen, _ = _gather_walk(plan, mask, row_vecs)
    want = np.zeros_like(seen)
    want[:, :, :row_vecs] = mask[:, :, None]
    assert seen[:, :, row_vecs:].sum() == 0
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("m,k,d,dtype", [
    (1280, 20, 128, "float32"), (1280, 20, 128, "bfloat16"),    # the drive
    (37, 40, 130, "float32"), (50, 9, 130, "bfloat16"),
    (13, 5, 64, "float32")])
def test_gather_reduce_plan_order_matches_oracle(m, k, d, dtype, n_sm):
    """The kernel's arithmetic in the plan's order (each slot group's
    float32 sum in slot order, the groups' sums added in (share, group)
    order, one division, one rounding) against the jnp oracle
    ``repro.kernels.ref.gather_reduce_ref``: float32 within rtol 1e-5 /
    atol 1e-6, bfloat16 within 2e-2 (the oracle sums and divides in bf16);
    at the drive's shape the grid gives every SM two CTAs of work."""
    elem = 4 if dtype == "float32" else 2
    plan = gather_reduce_plan(m, k, d, elem, n_sm=n_sm)
    if m == 1280:
        assert plan.grid[0] * plan.grid[1] >= 2 * n_sm
        assert k <= plan.ways * (32 // plan.lanes) * GATHER_UNROLL
    n = 3 * m
    rng = np.random.default_rng(m + k + d)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(-5, n + 5, (m, k)).astype(np.int32)
    mask = rng.random((m, k)) < 0.8
    mask[1:3] = False
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    rows = torch.from_numpy(table).to(tdt).float()[
        torch.from_numpy(idx).long().clamp(0, n - 1)]
    _, order = _gather_walk(plan, mask, d // plan.vec)
    got = torch.zeros((m, d))
    for row in range(m):
        parts = {}
        for way, g, slot in order[row]:
            part = parts.get((way, g), torch.zeros(d))
            parts[way, g] = part + rows[row, slot]
        for key in sorted(parts):
            got[row] = got[row] + parts[key]
    got = (got / torch.from_numpy(mask.sum(1, dtype=np.float32)).clamp(
        min=1)[:, None]).to(tdt)
    want = jref.gather_reduce_ref(jnp.asarray(table).astype(jdt),
                                  jnp.asarray(idx), jnp.asarray(mask))
    tol = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])
    assert not got[1:3].any()


def _tiered_cache(c1, c2, d, a1, a2, seed):
    """An L1 and an L2 with unique keys per set; half the L1's ids are
    also L2 residents (double hits), and a few slots stay empty with zero
    rows, as in a real state (the Pallas kernel lets the last matching
    way win, so an id of -1 in a set of several empty ways must find the
    same zeros whichever way serves it)."""
    k2, r2, pool2, rng = probe_cache(c2, d, a2, seed)
    k1, r1, pool1, _ = probe_cache(c1, d, a1, seed + 1)
    shared = rng.choice(k2[k2 >= 0], c1 // 2, replace=False)
    sets = np.asarray(jhash(jnp.asarray(shared), c1 // a1))
    k1[:] = -1
    fill = np.zeros(c1 // a1, np.int64)
    for pid, s in zip(np.concatenate([shared, pool1]),
                      np.concatenate([sets, np.asarray(
                          jhash(jnp.asarray(pool1), c1 // a1))])):
        if fill[s] < a1 and pid not in k1 and fill.sum() < c1 - c1 // 8 - 1:
            k1[s * a1 + fill[s]] = pid
            fill[s] += 1
    r1 = np.where((k1 >= 0)[:, None], r1 + 100.0, 0).astype(np.float32)
    r2 = np.where((k2 >= 0)[:, None], r2, 0).astype(np.float32)
    return k1, r1, k2, r2, np.concatenate([pool2, pool1]), rng


@pytest.mark.parametrize("c1,a1,c2,a2,r", [
    (16, 1, 64, 1, 77), (16, 2, 64, 2, 96), (16, 2, 64, 4, 33),
    (2, 2, 64, 4, 50),      # single-set L1
    (8, 1, 4, 4, 41)])      # single-set L2
def test_cache_probe_tiered_twin(c1, a1, c2, a2, r):
    """Two-tier probe twin vs the oracle and the Pallas kernel, exactly:
    L1 assoc 1/2, L2 assoc 1/2/4, single-set tiers, double hits (the L1
    wins), misses, -1 ids (which match empty slots, as in the oracle) and
    probe counts off a multiple of 32."""
    k1, r1, k2, r2, pool, rng = _tiered_cache(c1, c2, 8, a1, a2, c1 + c2 + r)
    ids = np.where(rng.random(r) < 0.7, rng.choice(pool, size=r),
                   rng.integers(0, 10 * c2, r)).astype(np.int32)
    ids[rng.random(r) < 0.1] = -1
    args = (k1, r1, k2, r2, ids)
    src, out = ops.cache_probe_tiered(*map(torch.from_numpy, args),
                                      l1_assoc=a1, l2_assoc=a2)
    assert src.dtype == torch.int32
    for use_kernel in (False, True):
        ws, wo = jops.cache_probe_tiered(*map(jnp.asarray, args),
                                         l1_assoc=a1, l2_assoc=a2,
                                         use_kernel=use_kernel)
        np.testing.assert_array_equal(src.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(out.numpy(), np.asarray(wo))
    both = np.isin(ids, k1) & np.isin(ids, k2) & (ids >= 0)
    if both.any():
        assert (src.numpy()[both] == 1).all()
    assert set(np.unique(src.numpy())) <= {0, 1, 2}


@pytest.mark.parametrize("m,k,d", [(8, 4, 16), (37, 9, 130), (5, 40, 64)])
def test_fanout_mean_backward_matches_jax_grad(m, k, d):
    """``fanout_mean_bwd_ref`` and ``FanoutMean``'s CPU backward (what
    ``ops.fanout_mean`` records for autograd) vs ``jax.grad`` of the
    oracle: exact, since both divide the same float32 gradient by the
    same count and multiply by 0 or 1."""
    rng = np.random.default_rng(m + k + d)
    x = rng.standard_normal((m, k, d)).astype(np.float32)
    mask = rng.random((m, k)) < 0.6
    mask[0] = False
    g = rng.standard_normal((m, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jref.fanout_mean_ref(xx, jnp.asarray(mask)),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = ref.fanout_mean_bwd_ref(torch.from_numpy(g), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.fanout_mean_bwd(torch.from_numpy(g),
                            torch.from_numpy(mask)).numpy(), want)
    xt = torch.from_numpy(x).requires_grad_(True)
    ops.fanout_mean(xt, torch.from_numpy(mask)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_fanout_mean_backward_bf16_matches_jax_grad():
    """bfloat16: the gradient is lifted to float32, divided, multiplied by
    the mask and rounded once — equal to ``jax.grad`` of the oracle."""
    rng = np.random.default_rng(9)
    m, k, d = 33, 7, 40
    mask = rng.random((m, k)) < 0.5
    g = rng.standard_normal((m, d)).astype(np.float32)
    gj = jnp.asarray(g, jnp.bfloat16)
    x0 = jnp.zeros((m, k, d), jnp.bfloat16)
    _, vjp = jax.vjp(lambda xx: jref.fanout_mean_ref(xx, jnp.asarray(mask)),
                     x0)
    want = np.asarray(vjp(gj)[0].astype(jnp.float32))
    got = ref.fanout_mean_bwd_ref(torch.from_numpy(g).to(torch.bfloat16),
                                  torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


#: the backward's shapes on the train steps' path: the deep step's two
#: hidden levels (level 0 twice a step) and the W = 4 step's
BWD_PATH_SHAPES = [(32, 15, 256), (480, 10, 256), (128, 40, 256)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("m,k,d", BWD_PATH_SHAPES + [
    (3, k, d) for k in (1, 31, 32, 33, 64) for d in (8, 130, 256)])
def test_fanout_mean_bwd_plan_covers_every_unit(m, k, d, n_sm):
    """The backward's launch plan, walked as ``fanout_mean_bwd.cu`` walks
    it (warp w of CTA (x, y, z) takes row x * BWD_WARPS + w, k = y, y +
    grid[1], ... and columns 32 z + lane): every (m, k, column) is written
    exactly once; CTAs of ``BWD_WARPS`` warps within the device's grid
    limits; and at the path's shapes the grid gives every SM two CTAs of
    work, or every warp a single k (132 SMs: the H100 SXM; 114: the
    PCIe card)."""
    gm, gy, gz = fanout_mean_bwd_plan(m, k, d, n_sm=n_sm)
    assert 1 <= gy <= k
    assert gm < 2 ** 31 and gy <= 65535 and gz <= 65535
    assert gz * 32 >= d > (gz - 1) * 32
    assert gm * BWD_WARPS >= m > (gm - 1) * BWD_WARPS
    written = np.zeros((m, k, d), np.int64)
    rows = np.arange(gm * BWD_WARPS)
    rows = rows[rows < m]
    cols = np.arange(gz * 32)
    cols = cols[cols < d]
    for way in range(gy):
        for kk in range(way, k, gy):
            written[np.ix_(rows, [kk], cols)] += 1
    assert (written == 1).all()
    if (m, k, d) in BWD_PATH_SHAPES:
        assert gm * gy * gz >= 2 * n_sm or gy == k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fanout_mean_bwd_select_matches_twin(dtype):
    """The kernel's arithmetic in torch: q = g / max(count, 1) in float32
    once per (m, d), q * 1 and q * 0 rounded once each, one of the two
    stored per k by the mask bit — equal to the twin, bit for bit, also
    where g holds inf and nan (q * 0 is nan there, as the twin's product
    with the float mask is) and negative values (-0.0 where masked)."""
    rng = np.random.default_rng(3)
    m, k, d = 40, 33, 24
    g = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    g[1, :4] = torch.tensor([float("inf"), -float("inf"), float("nan"), -3.])
    g = g.to(dtype)
    mask = torch.from_numpy(rng.random((m, k)) < 0.6)
    mask[2] = False
    q = g.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
    on, off = (q * 1.0).to(dtype), (q * 0.0).to(dtype)
    got = torch.where(mask[:, :, None], on[:, None, :], off[:, None, :])
    want = ref.fanout_mean_bwd_ref(g, mask)
    assert torch.equal(got.isnan(), want.isnan()) and want.isnan().any()
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(torch.signbit(got[fin]), torch.signbit(want[fin]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,d", BWD_PATH_SHAPES[:2])
def test_fanout_mean_backward_deep_shapes(m, k, d, dtype):
    """``fanout_mean_bwd_ref`` against ``jax.grad`` of the oracle at the
    deep config's own backward shapes (batch 32, fanouts 15 then 10,
    hidden 256), with every fifth row all masked: exact in float32, and in
    bfloat16 (the gradient lifted to float32, divided, multiplied by the
    mask, rounded once, in both)."""
    rng = np.random.default_rng(m + k)
    mask = rng.random((m, k)) < 0.7
    mask[::5] = False
    g = rng.standard_normal((m, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gj = jnp.asarray(g, jdt)
    _, vjp = jax.vjp(lambda xx: jref.fanout_mean_ref(xx, jnp.asarray(mask)),
                     jnp.zeros((m, k, d), jdt))
    want = np.asarray(vjp(gj)[0].astype(jnp.float32))
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    got = ref.fanout_mean_bwd_ref(gt, torch.from_numpy(mask))
    assert got.dtype == gt.dtype and got.shape == (m, k, d)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[::5].any()


@pytest.mark.parametrize("d,elem,aligned", [(128, 4, True), (128, 2, True),
                                            (130, 4, True), (128, 4, False),
                                            (3, 4, True)])
@pytest.mark.parametrize("r", [1, 31, 33, 29312])
def test_tiered_plan_covers_every_id(r, d, elem, aligned):
    """The tiered probe's plan: one lane per id over ``TIERED_IDS``-id
    warps, every id in exactly one lane, CTAs of ``TIERED_WARPS`` warps
    within the device's grid, all 132 SMs given work at the deep step's
    R = 29 312; and the warp's row walk as ``cache_probe_tiered.cu`` does
    it (unit u = lane + 32 i of the warp's rows, column and row advanced
    by 32 % and 32 / the row's units) writes every unit of every row
    exactly once."""
    plan = tiered_plan(r, d, elem, aligned=aligned)
    vec = 16 // elem if aligned and (d * elem) % 16 == 0 else 1
    assert plan.vec == vec and 1 <= TIERED_IDS <= 32
    assert plan.grid < 2 ** 31
    per_cta = TIERED_WARPS * TIERED_IDS
    assert plan.grid * per_cta >= r > (plan.grid - 1) * per_cta
    owner = np.zeros(plan.grid * per_cta, np.int64)
    np.add.at(owner, np.arange(r), 1)
    assert (owner[:r] == 1).all()
    if r == 29312:
        assert plan.grid >= 132
    row_vecs = d // plan.vec
    for n in {min(r, TIERED_IDS), r % TIERED_IDS or TIERED_IDS}:
        seen = np.zeros((n, row_vecs), np.int64)
        for lane in range(32):
            j, c = divmod(lane, row_vecs)
            for u in range(lane, -(-n * row_vecs // 32) * 32, 32):
                assert (j, c) == divmod(u, row_vecs)
                if u < n * row_vecs:
                    seen[j, c] += 1
                    assert j < n
                j += 32 // row_vecs
                c += 32 % row_vecs
                if c >= row_vecs:
                    c -= row_vecs
                    j += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("source,name,value", [
    ("cache_probe_tiered.cu", "kIdsPerWarp", TIERED_IDS),
    ("cache_probe_tiered.cu", "kWarps", TIERED_WARPS),
    ("fanout_mean_bwd.cu", "kWarps", BWD_WARPS),
    ("gather_reduce.cu", "kWarps", GATHER_WARPS),
    ("gather_reduce.cu", "kUnroll", GATHER_UNROLL)])
def test_plans_match_kernel_constants(source, name, value):
    """``tiered_plan``, ``fanout_mean_bwd_plan`` and ``gather_reduce_plan``
    size their grids with the kernels' own ids per warp, warps per CTA and
    loads in flight, compile-time constants of their sources."""
    path = os.path.join(os.path.dirname(cache_gather.__file__), "csrc",
                        source)
    with open(path) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert found == [str(value)]


def _deep_tiers(seed, d=128):
    """graphgen-gcn-deep's tiers: a 512-row 2-way L1 and a 4 096-row 4-way
    L2 of ``d`` float32 columns, as ``_tiered_cache`` fills them (half the
    L1's ids also L2 residents, a few empty slots with zero rows)."""
    return _tiered_cache(512, 4096, d, 2, 4, seed)


@pytest.mark.parametrize("case", ["mixed", "all_miss", "all_l1"])
def test_cache_probe_tiered_twin_deep_tiers(case):
    """``ref.cache_probe_tiered_ref`` against ``repro``'s oracle at the
    deep config's tiers (L1 512 x 2-way, L2 4 096 x 4-way, D 128),
    exactly: a mixed id set with -1 pads (which match the empty slots, as
    in the oracle), double hits (the L1 wins) and misses; an all-miss set;
    and a set of L1 residents only."""
    k1, r1, k2, r2, pool, rng = _deep_tiers(18)
    r = 2000
    if case == "mixed":
        # empty the last way of -1's L2 set, so a -1 pad finds an empty slot
        s2 = int(np.asarray(jhash(jnp.asarray([-1], jnp.int32), 1024))[0])
        k2[s2 * 4 + 3], r2[s2 * 4 + 3] = -1, 0
        ids = np.where(rng.random(r) < 0.7, rng.choice(pool, size=r),
                       rng.integers(0, 10 * 4096, r)).astype(np.int32)
        ids[rng.random(r) < 0.1] = -1
    elif case == "all_miss":
        ids = rng.integers(20 * 4096, 30 * 4096, r).astype(np.int32)
    else:
        ids = rng.choice(k1[k1 >= 0], size=r).astype(np.int32)
    src, out = ref.cache_probe_tiered_ref(
        *map(torch.from_numpy, (k1, r1, k2, r2, ids)), l1_assoc=2,
        l2_assoc=4)
    ws, wo = jref.cache_probe_tiered_ref(*map(jnp.asarray,
                                              (k1, r1, k2, r2, ids)),
                                         l1_assoc=2, l2_assoc=4)
    np.testing.assert_array_equal(src.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(out.numpy(), np.asarray(wo))
    s = src.numpy()
    if case == "mixed":
        both = np.isin(ids, k1) & np.isin(ids, k2) & (ids >= 0)
        assert both.any() and (s[both] == 1).all()
        assert (s == 0).any() and (s == 2).any()
        assert (s[ids == -1] > 0).all()     # -1 matches an empty slot
    elif case == "all_miss":
        assert not s.any() and not out.numpy().any()
    else:
        assert (s == 1).all()


def test_dispatch_refuses_mixed_or_unknown_devices():
    """ops never guesses a device: CPU with meta (or any non-CPU,
    non-CUDA device) raises."""
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.fanout_mean(x, torch.zeros(2, 3, dtype=torch.bool, device="meta"))


def test_build_without_nvcc_raises(monkeypatch):
    """With no CUDA toolkit the build raises; nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "_absent")
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_gather_reduce_dispatch_refuses():
    """The CUDA wrapper refuses CPU operands, non-int32 ids and mismatched
    shapes before it reaches the library; ops refuses a device mix."""
    from repro_torch.kernels.gather_reduce import gather_reduce_cuda
    table = torch.zeros(10, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="one CUDA device"):
        gather_reduce_cuda(table, idx, mask)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.gather_reduce(table, idx.to("meta"), mask)
    assert "gather_reduce" in ops.KERNELS


def test_launch_counters_reset():
    """The launch counters read and reset through ops."""
    ops.reset_launch_counts()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_fanout_mean_kernel_on_card(cuda, dtype, tol):
    """CUDA fanout_mean vs its twin on the card."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, 20, 130, generator=g, device=cuda).to(dtype)
    mask = torch.rand(300, 20, generator=g, device=cuda) < 0.7
    ops.reset_launch_counts()
    got = ops.fanout_mean(x, mask)
    assert ops.launch_counts()["fanout_mean"] == 1
    want = ref.fanout_mean_ref(x, mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol / 10)


@pytest.mark.cuda
@pytest.mark.parametrize("assoc", [1, 2, 4])
def test_probe_kernels_on_card(cuda, assoc):
    """CUDA probe kernels vs their twins on the card, exactly."""
    keys, rows, pool, rng = probe_cache(256, 40, assoc, assoc)
    ids = np.where(rng.random((3, 333)) < 0.5,
                   rng.choice(pool, size=(3, 333)),
                   rng.integers(-1, 2560, (3, 333))).astype(np.int32)
    k, r, i = (torch.from_numpy(a).to(cuda) for a in (keys, rows, ids))
    ops.reset_launch_counts()
    for a, b in zip(ops.cache_probe_gather(k, r, i[0], assoc=assoc),
                    ref.cache_probe_gather_ref(k, r, i[0], assoc=assoc)):
        assert torch.equal(a, b)
    k, r, i = k[None], r[None], i[None]
    for hit_cap in (1, 50, 4096):
        for a, b in zip(ops.cache_probe_compact(k, r, i, assoc=assoc,
                                                hit_cap=hit_cap),
                        ref.cache_probe_compact_ref(k, r, i, assoc=assoc,
                                                    hit_cap=hit_cap)):
            assert torch.equal(a, b)
    assert ops.launch_counts()["cache_probe_gather"] == 1
    assert ops.launch_counts()["cache_probe_compact"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("c1,a1,c2,a2,r", [(16, 1, 64, 1, 77),
                                            (16, 2, 64, 4, 33),
                                            (2, 2, 64, 4, 50),
                                            (512, 2, 4096, 4, 26912)])
def test_cache_probe_tiered_kernel_on_card(cuda, c1, a1, c2, a2, r):
    """CUDA two-tier probe vs its twin on the card, exactly (-1 ids and
    double hits included)."""
    k1, r1, k2, r2, pool, rng = _tiered_cache(c1, c2, 40, a1, a2, r)
    ids = np.where(rng.random(r) < 0.7, rng.choice(pool, size=r),
                   rng.integers(0, 10 * c2, r)).astype(np.int32)
    ids[rng.random(r) < 0.1] = -1
    args = [torch.from_numpy(a).to(cuda) for a in (k1, r1, k2, r2, ids)]
    ops.reset_launch_counts()
    for a, b in zip(ops.cache_probe_tiered(*args, l1_assoc=a1, l2_assoc=a2),
                    ref.cache_probe_tiered_ref(*args, l1_assoc=a1,
                                               l2_assoc=a2)):
        assert torch.equal(a, b)
    assert ops.launch_counts()["cache_probe_tiered"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fanout_mean_bwd_kernel_on_card(cuda, dtype):
    """CUDA backward vs its twin on the card (exact: one division and one
    rounding in both), and through autograd: ``FanoutMean`` on a CUDA
    tensor launches the forward and the backward kernel once each."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(300, 20, 130, generator=g, device=cuda).to(dtype)
    mask = torch.rand(300, 20, generator=g, device=cuda) < 0.7
    mask[:2] = False
    dy = torch.randn(300, 130, generator=g, device=cuda).to(dtype)
    ops.reset_launch_counts()
    assert torch.equal(ops.fanout_mean_bwd(dy, mask),
                       ref.fanout_mean_bwd_ref(dy, mask))
    xg = x.clone().requires_grad_(True)
    ops.fanout_mean(xg, mask).backward(dy)
    assert torch.equal(xg.grad, ref.fanout_mean_bwd_ref(dy, mask))
    counts = ops.launch_counts()
    assert counts["fanout_mean"] == 1 and counts["fanout_mean_bwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-6)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
def test_gather_reduce_kernel_on_card(cuda, dtype, tol):
    """CUDA gather_reduce vs its twin on the card at a graphgen-gcn hop-2
    level's shape (20 000 x 128 table, 1280 x 20 slots), with clamped ids
    and all-masked rows."""
    g = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn(20_000, 128, generator=g, device=cuda).to(dtype)
    idx = torch.randint(-5, 20_005, (1280, 20), generator=g, device=cuda,
                        dtype=torch.int32)
    mask = torch.rand(1280, 20, generator=g, device=cuda) < 0.7
    mask[:3] = False
    ops.reset_launch_counts()
    got = ops.gather_reduce(table, idx, mask)
    assert ops.launch_counts()["gather_reduce"] == 1
    want = ref.gather_reduce_ref(table, idx, mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
