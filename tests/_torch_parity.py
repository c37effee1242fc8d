"""Shared helpers of the ``test_torch_*`` parity tests (``repro`` against
``repro_torch``).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU.  The sampler's random draws come from ``jax.random``
exactly as ``repro``'s generator draws them, and are fed to the port's
draws seam, so both packages sample the same candidates.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_forced(code: str, devices: int = 4) -> str:
    """Run ``code`` in a fresh interpreter with ``devices`` forced host
    devices (copy of the pattern in ``tests/test_distributed.py``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    prologue = (
        "import os\n"
        f"os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count={devices}'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", prologue + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def jax_round_draws(rng, n_workers: int, batch: int, fanouts) -> list:
    """The draws ``repro.core.generation._worker_generate`` makes for one
    round keyed ``rng``: per hop ``(offs [W, F, k] int32, e [W, F, k]
    float32)`` as numpy, with ``e = -log(u)``."""
    import jax
    import jax.numpy as jnp

    hops = []
    f = n_workers * batch
    per_worker = [jax.random.split(jax.random.fold_in(rng, me),
                                   max(len(fanouts), 2))
                  for me in range(n_workers)]
    for level, k in enumerate(fanouts):
        offs, es = [], []
        for me in range(n_workers):
            o, e = hop_draws(per_worker[me][level], f, k)
            offs.append(o)
            es.append(e)
        hops.append((np.stack(offs), np.stack(es)))
        f *= k
    return hops


def hop_draws(rng, f: int, k: int):
    """``local_candidates``' draws for one hop key: ``(offs, e)`` numpy."""
    offs, e = _hop_draws_fn(f, k)(rng)
    return np.array(offs), np.array(e)


@functools.lru_cache(maxsize=None)
def _hop_draws_fn(f: int, k: int):
    import jax
    import jax.numpy as jnp

    def draws(rng):
        r_off, r_key = jax.random.split(rng)
        offs = jax.random.randint(r_off, (f, k), 0, jnp.iinfo(jnp.int32).max)
        u = jax.random.uniform(r_key, (f, k),
                               minval=jnp.finfo(jnp.float32).tiny)
        return offs, -jnp.log(u)
    return jax.jit(draws)


def torch_draws(hops):
    """numpy draws -> the port's draws tuple (CPU tensors)."""
    import torch
    return tuple((torch.from_numpy(np.ascontiguousarray(o)),
                  torch.from_numpy(np.ascontiguousarray(e)))
                 for o, e in hops)


def as_u32(a) -> np.ndarray:
    """Bitmap words of either package as uint32 (the port carries the
    int32 bit pattern)."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def assert_state_equal(jax_state, torch_state):
    """Every leaf of a cache state equal, bit for bit."""
    for name, want, got in zip(("keys", "rows", "tags", "counts"),
                               jax_state, torch_state):
        want = np.asarray(want)
        got = got.cpu().numpy()
        assert want.shape == got.shape, (name, want.shape, got.shape)
        assert want.tobytes() == got.tobytes(), name


def assert_batch_equal(jax_batch, torch_batch):
    """Ids, masks, features, labels and counters of two batches equal."""
    def np_(t):
        return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                 "n_cache_misses", "n_probe_demoted"):
        np.testing.assert_array_equal(np_(getattr(torch_batch, name)),
                                      np.asarray(getattr(jax_batch, name)),
                                      err_msg=name)
    for name in ("hops", "masks", "x_hops"):
        for level, (w, g) in enumerate(zip(getattr(jax_batch, name),
                                           getattr(torch_batch, name))):
            np.testing.assert_array_equal(np_(g), np.asarray(w),
                                          err_msg=f"{name}[{level}]")


def probe_cache(c: int, d: int, assoc: int, seed: int):
    """A populated ``assoc``-way cache hashed by the port (bit-equal to
    ``repro``'s hash): ``(keys [C] int32, rows [C, D] float32, pool, rng)``
    with keys unique per set, drawn from ``pool`` (a few slots empty)."""
    import torch
    from repro_torch.core.feature_cache import hash_slots
    rng = np.random.default_rng(seed)
    n_sets = c // assoc
    pool = rng.choice(10 * c, size=c, replace=False).astype(np.int32)
    sets = hash_slots(torch.from_numpy(pool), n_sets).numpy()
    keys = np.full(c, -1, np.int32)
    fill = np.zeros(n_sets, np.int64)
    for pid, s in zip(pool, sets):
        if fill[s] < assoc:
            keys[s * assoc + fill[s]] = pid
            fill[s] += 1
    rows = rng.standard_normal((c, d)).astype(np.float32)
    return keys, rows, pool, rng


def resident_absent(keys: np.ndarray):
    """The ids a cache holds, and ids in ``[0, 10 C)`` it does not."""
    resident = keys[keys >= 0]
    return resident, np.setdiff1d(np.arange(10 * keys.size, dtype=np.int32),
                                  resident)


def compact_word_ranges(plan, n_words: int):
    """The ``[lo, hi)`` bitmap words each cluster rank of a
    ``cache_gather.compact_plan`` owns, as the kernel computes them (the
    last ranks may own none)."""
    return [(min(c * plan.words_per_cta, n_words),
             min((c + 1) * plan.words_per_cta, n_words))
            for c in range(plan.cluster)]


#: edge cases of the compact probe's launch plan (one holder, W 3, R 333 =
#: 11 bitmap words: cluster ranks of 2 words, the last two owning none)
COMPACT_EDGES = ("r_off_plan", "cap_on_boundary", "last_segment_only",
                 "all_miss", "all_minus_one", "cap_is_r")


def compact_edge(case: str, c: int = 256, d: int = 8, w: int = 3,
                 r: int = 333, assoc: int = 2, seed: int = 7):
    """``(keys [C], rows [C, D], ids [W, R], hit_cap)`` for one of
    ``COMPACT_EDGES``: R off a multiple of 32 x S with demotion across
    ranks; hit_cap equal to the first rank's hits (every row probes the
    same ids); hits only in the last rank that owns words; all misses;
    all ``-1``; hit_cap equal to R."""
    from repro_torch.kernels.cache_gather import compact_plan
    keys, rows, _, rng = probe_cache(c, d, assoc, seed)
    resident, absent = resident_absent(keys)
    ids = np.where(rng.random((w, r)) < 0.5,
                   rng.choice(resident, size=(w, r)),
                   rng.choice(absent, size=(w, r))).astype(np.int32)
    ids[rng.random((w, r)) < 0.1] = -1
    hit_cap = 40
    ranges = compact_word_ranges(compact_plan(1, w, r, c), -(-r // 32))
    if case == "cap_on_boundary":
        ids[:] = ids[0]
        hi = ranges[0][1] * 32
        hit_cap = int(np.isin(ids[0, :hi], resident).sum())
    elif case == "last_segment_only":
        lo = max(a for a, b in ranges if b > a) * 32
        ids[:, :lo] = rng.choice(absent, size=(w, lo))
        ids[:, lo:] = rng.choice(resident, size=(w, r - lo))
        hit_cap = 3
    elif case == "all_miss":
        ids = rng.choice(absent, size=(w, r)).astype(np.int32)
    elif case == "all_minus_one":
        ids[:] = -1
    elif case == "cap_is_r":
        hit_cap = r
    return keys, rows, ids, hit_cap
