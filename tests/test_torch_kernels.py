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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import as_u32  # noqa: E402
from repro.core.feature_cache import hash_slots as jhash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402


def _cache(c, d, assoc, seed):
    """A populated ``assoc``-way cache (keys unique per set) and its pool."""
    rng = np.random.default_rng(seed)
    n_sets = c // assoc
    pool = rng.choice(10 * c, size=c, replace=False).astype(np.int32)
    sets = np.asarray(jhash(jnp.asarray(pool), n_sets))
    keys = np.full(c, -1, np.int32)
    fill = np.zeros(n_sets, np.int64)
    for pid, s in zip(pool, sets):
        if fill[s] < assoc:
            keys[s * assoc + fill[s]] = pid
            fill[s] += 1
    rows = rng.standard_normal((c, d)).astype(np.float32)
    return keys, rows, pool, rng


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
    keys, rows, pool, rng = _cache(c, d, assoc, c + r + assoc)
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
    keys, rows, pool, rng = _cache(c, d, assoc, c + r + assoc)
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
    parts = [_cache(c, d, 2, s) for s in (1, 2)]
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


def _tiered_cache(c1, c2, d, a1, a2, seed):
    """An L1 and an L2 with unique keys per set; half the L1's ids are
    also L2 residents (double hits), and a few slots stay empty with zero
    rows, as in a real state (the Pallas kernel lets the last matching
    way win, so an id of -1 in a set of several empty ways must find the
    same zeros whichever way serves it)."""
    k2, r2, pool2, rng = _cache(c2, d, a2, seed)
    k1, r1, pool1, _ = _cache(c1, d, a1, seed + 1)
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
    keys, rows, pool, rng = _cache(256, 40, assoc, assoc)
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
