"""The dry-run's cost accounting (``repro_torch/launch/trace_analysis.py``,
``core/collectives.py::FakeWorkers`` and ``kernels/ops.py``'s fake
branch) on programs whose counts are known in closed form, as
``tests/test_hlo_analysis.py`` holds the reference's: N stacked layers
count N times one layer (the eager trace's stand-in for trip-count
weighting), a training step counts its forward and backward products,
views move no bytes and a gather counts the rows it returns.  The
kernels' ``work`` functions give the bounds ``chip_smoke.py`` printed
before they existed (its formulas are copied here), a fake operand
never launches or moves ``launch_counts()``, and ``resolve_device``
still refuses ``cuda`` without a card.  Every comparison is exact."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.core.collectives import FakeWorkers, new_tally  # noqa: E402
from repro_torch.core.config import resolve_device  # noqa: E402
from repro_torch.kernels import (cache_gather, flash_attention,  # noqa: E402
                                 gather_reduce, ops, ref, ssd_scan)
from repro_torch.launch.trace_analysis import CostMode, trace_step  # noqa: E402


def _chain(n, d=256, rows=128, act=torch.tanh, grad=False):
    """``trace_step`` of ``n`` layers ``act(x @ w)``; with ``grad`` the
    gradient of the output's sum with respect to x only."""
    with FakeTensorMode():
        x = torch.empty(rows, d, requires_grad=grad)
        ws = [torch.empty(d, d) for _ in range(n)]

        def fwd(x, ws):
            for w in ws:
                x = act(x @ w)
            return x

        def step(x, ws):
            return torch.autograd.grad(fwd(x, ws).sum(), x)[0]
        return trace_step(step if grad else fwd, (x, ws))


@pytest.mark.parametrize("n", [1, 4, 12])
def test_stacked_layers_count_n_times_one(n):
    """An eager trace runs every layer: n layers count n times one
    layer's FLOPs and bytes (what the reference's trip-count weighting
    recovers from a ``while`` body counted once)."""
    one, many = _chain(1), _chain(n)
    assert many["aten_flops"] == n * one["aten_flops"] == n * 2 * 128 * 256 ** 2
    assert many["aten_bytes"] == n * one["aten_bytes"]


def test_training_step_counts_forward_and_backward():
    """The gradient of a 12-layer nonlinear chain with respect to x: 12
    forward products (tanh' needs the activations) and 12 backward ``dx``
    products, as ``test_hlo_analysis.test_nonlinear_scan_counts_fwd_and_bwd``
    counts the reference's."""
    res = _chain(12, d=128, rows=64, grad=True)
    assert res["aten_flops"] == 24 * 2 * 64 * 128 * 128


def test_memory_keys():
    """Arguments are the inputs' storages, the output its result's, temp
    the peak of live storages above the arguments (the output inside it),
    and no generated code."""
    res = _chain(3, d=64, rows=32)
    mem = res["memory"]
    assert mem["argument_bytes"] == 4 * (32 * 64 + 3 * 64 * 64)
    assert mem["output_bytes"] == 4 * 32 * 64
    # x @ w and its tanh live together at the peak, the previous layer's
    # output too
    assert 2 * mem["output_bytes"] <= mem["temp_bytes"] <= 3 * 4 * 32 * 64
    assert mem["generated_code_bytes"] == 0


def test_views_are_free_and_gathers_count_rows():
    """Views move nothing; ``table[idx]`` counts the rows it returns and
    the ids (not the table); an in-place update twice its operand."""
    with FakeTensorMode():
        table = torch.empty(1000, 64)
        idx = torch.zeros(10, dtype=torch.int64)
        mode = CostMode()
        with mode:
            v = table.view(64, 1000).t()
        assert mode.bytes == 0
        with mode:
            rows = table[idx]
        assert mode.bytes == 10 * 64 * 4 + 10 * 8
        mode.bytes = 0
        with mode:
            table[idx] = rows
        assert mode.bytes == 2 * (10 * 8 + 10 * 64 * 4)
    del v


def test_fake_workers_shapes_and_counts():
    """Each collective returns the rank's block shape and dtype; ``tally``
    holds the output bytes per device by the reference's kind names,
    ``stats`` the bytes sent as ``ProcessWorkers`` counts them; a group
    of one rank adds nothing to the tally."""
    tally = new_tally()
    g = FakeWorkers(4, 0, "cpu", tally)
    with FakeTensorMode():
        x = torch.empty(1, 4, 6, dtype=torch.float32)
        m = torch.empty(1, 8, dtype=torch.bool)
        assert g.all_gather(x).shape == (1, 16, 6)
        assert g.all_to_all(x).shape == (1, 4, 6)
        assert g.ppermute(x, [(0, 1), (1, 0)]).shape == (1, 4, 6)
        assert g.all_reduce(x, "max").shape == (1, 4, 6)
        assert g.broadcast(m).dtype == torch.bool
        block = 4 * 6 * 4
        assert tally == {"all-gather": 4 * block, "all-to-all": block,
                         "collective-permute": block, "all-reduce": block,
                         "broadcast": 8, "reduce-scatter": 0}
        assert {k: (v["calls"], v["bytes"]) for k, v in g.stats.items()} == {
            "all_gather": (1, 3 * block), "all_to_all": (1, 3 * block // 4),
            "ppermute": (1, block), "all_reduce": (1, block),
            "broadcast": (1, 3 * 8)}
        one = FakeWorkers(1, 0, "cpu", tally)
        one.all_reduce(x)
        assert tally["all-reduce"] == block
        with pytest.raises(ValueError):
            g.all_to_all(torch.empty(1, 3, 6))


# The bounds chip_smoke.py printed before the kernels had work functions,
# copied from its time_kernel; each work function must give them exactly.

def _old_fanout_mean(m, k, d):
    return 2 * m * k * d + m * d, m * k * d * 4 + m * k + m * d * 4


def _old_fanout_mean_bwd(m, k, d, item=4):
    return m * k + m * d + m * k * d, m * d * item + m * k + m * k * d * item


def _old_gather(r, c, d, assoc, hit_rows):
    return r * (2 + assoc), r * 4 + c * 4 + hit_rows * d * 4 + r + r * d * 4


def _old_tiered(r, c1, c2, d, a1, a2, hit_rows):
    return (r * (4 + a1 + a2),
            r * 4 + (c1 + c2) * 4 + hit_rows * d * 4 + r * 4 + r * d * 4)


def _old_compact(h, w, r, c, d, assoc, hit_cap, kept):
    n_words, hc = -(-r // 32), min(hit_cap, r)
    return (h * w * r * (2 + assoc),
            h * w * r * 4 + h * c * 4 + kept * d * 4
            + 2 * h * w * n_words * 4 + h * w * hc * d * 4)


def _old_flash(b, hq, lq, lk, dh, hkv, causal, item):
    rows = torch.arange(lq, dtype=torch.int64)
    pairs = (int(torch.clamp(rows + (lk - lq) + 1, 0, lk).sum())
             if causal else lq * lk)
    return 4 * b * hq * dh * pairs, 2 * (b * hq * lq * dh
                                         + b * hkv * lk * dh) * item


def _old_ssd(b, l, h, p, n, chunk, item):
    q = min(chunk, l)
    nc, pairs = l // q, q * (q + 1) // 2
    ops_n = (2 * b * nc * pairs * n + b * h * nc * pairs * (2 * p + 3)
             + 2 * b * h * (l - q) * 2 * n * p)
    return ops_n, item * (2 * b * l * h * p + 2 * b * l * n) + 4 * (b * l * h
                                                                  + h)


def _old_gather_reduce(m, k, d, item, kept, distinct):
    return kept * d + m * d, distinct * d * item + m * k * 4 + m * k + m * d * item


@pytest.mark.parametrize("seed", range(3))
def test_work_functions_give_the_printed_bounds(seed):
    """At random shapes and data counts, every kernel's work function
    gives ``chip_smoke.py``'s earlier operation and byte counts."""
    rng = np.random.default_rng(seed)

    def n(lo, hi):
        return int(rng.integers(lo, hi))
    m, k, d = n(1, 5000), n(1, 41), n(1, 300)
    assert gather_reduce.fanout_mean_work(m, k, d) == _old_fanout_mean(m, k, d)
    assert gather_reduce.fanout_mean_bwd_work(m, k, d) == \
        _old_fanout_mean_bwd(m, k, d)
    r, c, hit = n(1, 30000), 1 << n(4, 13), n(0, 4000)
    assert cache_gather.cache_probe_gather_work(r, c, d, 4, hit_rows=hit) \
        == _old_gather(r, c, d, 4, hit)
    c1 = 1 << n(3, 10)
    assert cache_gather.cache_probe_tiered_work(
        r, c1, c, d, 1, 4, hit_rows=hit) == _old_tiered(r, c1, c, d, 1, 4, hit)
    h, w, hc, kept = n(1, 9), n(1, 9), n(1, 500), n(0, 900)
    assert cache_gather.cache_probe_compact_work(
        h, w, r, c, d, 4, hc, kept=kept) == _old_compact(h, w, r, c, d, 4,
                                                         hc, kept)
    b, hkv = n(1, 9), n(1, 4)
    hq, dh = hkv * n(1, 5), 64 * n(1, 3)
    lq = 64 * n(1, 40)
    lk = lq + 64 * n(0, 4)
    for causal in (True, False):
        assert flash_attention.flash_attention_work(
            b, hq, lq, lk, dh, hkv, causal) == _old_flash(
                b, hq, lq, lk, dh, hkv, causal, 2)
    ell, chunk = 128 * n(1, 32), 128
    hh, p, st = n(1, 64), 64, 128
    assert ssd_scan.ssd_scan_work(b, ell, hh, p, st, chunk) == _old_ssd(
        b, ell, hh, p, st, chunk, 2)
    rows = n(10, 10000)
    kept_slots = n(0, m * k + 1)
    distinct = min(kept_slots, rows)
    assert gather_reduce.gather_reduce_work(
        m, k, d, rows, 4, kept=kept_slots, distinct=distinct) == \
        _old_gather_reduce(m, k, d, 4, kept_slots, distinct)


def _operands(gen):
    """Each kernel op's name, function and keyword arguments, and a
    builder of its operands on a device (the flash and SSD ones at the
    kernels' own head dims)."""
    def f32(*s):
        return torch.randn(*s, generator=gen)

    def ids(*s, hi=64):
        return torch.randint(0, hi, s, generator=gen, dtype=torch.int32)
    mask = torch.rand(6, 5, generator=gen) > 0.3
    keys = torch.arange(16, dtype=torch.int32)
    return [
        ("fanout_mean", {}, (f32(6, 5, 8), mask)),
        ("fanout_mean_bwd", {}, (f32(6, 8), mask)),
        ("cache_probe_gather", {"assoc": 2}, (keys, f32(16, 8), ids(10))),
        ("cache_probe_compact", {"assoc": 1, "hit_cap": 4},
         (keys.reshape(2, 8), f32(2, 8, 8), ids(2, 2, 40))),
        ("cache_probe_tiered", {"l1_assoc": 1, "l2_assoc": 2},
         (keys[:8], f32(8, 8), keys, f32(16, 8), ids(10))),
        ("flash_attention", {"causal": True},
         (f32(1, 2, 64, 64), f32(1, 1, 64, 64), f32(1, 1, 64, 64))),
        ("ssd_scan", {"chunk": 32},
         (f32(1, 64, 2, 16), torch.rand(1, 64, 2, generator=gen),
          -torch.rand(2, generator=gen), f32(1, 64, 16), f32(1, 64, 16))),
        ("gather_reduce", {}, (f32(20, 8), ids(6, 5, hi=20), mask)),
    ]


def test_fake_operands_never_launch():
    """On fake operands every op returns its kernel's output shapes and
    dtypes, records the call and its work in ``fake_tally``, and leaves
    ``launch_counts()`` as it was; on real CPU operands it is the twin."""
    gen = torch.Generator().manual_seed(0)
    cases = _operands(gen)
    before = ops.launch_counts()
    for name, kw, real in cases:
        want = getattr(ref, name + "_ref")(*real, **kw)
        got = getattr(ops, name)(*real, **kw)
        for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (got, want))):
            assert torch.equal(a, b), name
        mode = FakeTensorMode()
        fake = tuple(mode.from_tensor(t) for t in real)
        with mode, ops.fake_tally() as tally:
            out = getattr(ops, name)(*fake, **kw)
        for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (out, want))):
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        assert tally[name]["calls"] == 1 and tally[name]["bytes"] > 0, name
    assert ops.launch_counts() == before


def test_fake_branch_refuses_what_the_kernel_refuses():
    """The fake branch checks what the wrappers check without data: a
    flash head dim the kernels are not built for, an SSD chunk that does
    not divide L, a bfloat16 SSD head dim the tensor cores do not take."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 64, 16)
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention(q, q, q)
        x = torch.empty(1, 48, 2, 16)
        dt, a, bm = torch.empty(1, 48, 2), torch.empty(2), torch.empty(1, 48, 16)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ops.ssd_scan(x, dt, a, bm, bm, chunk=32)
        x16, b16 = x.to(torch.bfloat16), bm.to(torch.bfloat16)
        with pytest.raises(ValueError, match="bfloat16 ssd_scan"):
            ops.ssd_scan(x16, dt, a, b16, b16, chunk=48)


def test_resolve_device_still_refuses_cuda():
    """The dry-run does not loosen ``resolve_device``: without a card a
    real entry point still refuses ``cuda``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert math.isfinite(float(resolve_device("cpu").index or 0))
