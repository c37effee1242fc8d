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


def tiered_blocks(c1: int, a1: int, c2: int, a2: int, d: int, seed: int,
                  minus_one_slot: bool = False):
    """An L1 (``c1`` rows, ``a1``-way) and an L2 (``c2``, ``a2``-way) of
    ``d`` float32 columns hashed by the port: keys unique per set, half the
    L1's ids also L2 residents (double hits), a few slots empty with zero
    rows as in a real state.  With ``minus_one_slot`` the last way of -1's
    set in each tier is emptied, so an id of -1 matches there.  Returns
    ``(k1, r1, k2, r2, pool, rng)`` as numpy, ``pool`` the resident ids."""
    import torch
    from repro_torch.core.feature_cache import hash_slots
    k2, r2, pool2, rng = probe_cache(c2, d, a2, seed)
    resident = k2[k2 >= 0]
    cand = np.concatenate([
        rng.choice(resident, min(c1 // 2, resident.size), replace=False),
        rng.choice(10 * c2, c1, replace=False).astype(np.int32) + 10 * c2])
    sets = hash_slots(torch.from_numpy(cand), c1 // a1).numpy()
    k1 = np.full(c1, -1, np.int32)
    fill = np.zeros(c1 // a1, np.int64)
    for pid, s in zip(cand, sets):
        if fill[s] < a1 and pid not in k1 and fill.sum() < c1 - c1 // 8 - 1:
            k1[s * a1 + fill[s]] = pid
            fill[s] += 1
    r1 = rng.standard_normal((c1, d)).astype(np.float32) + 100
    if minus_one_slot:
        for keys, c, a in ((k1, c1, a1), (k2, c2, a2)):
            s = int(hash_slots(torch.tensor([-1], dtype=torch.int32),
                               c // a)[0])
            keys[s * a + a - 1] = -1
    r1[k1 < 0] = 0
    r2[k2 < 0] = 0
    return k1, r1, k2, r2, np.concatenate([pool2, k1[k1 >= 0]]), rng


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


# ------------------------------------------------------------ LM parity

def lm_dtypes(name: str):
    """``(torch dtype, jax dtype)`` of a compute dtype's name."""
    import jax.numpy as jnp
    import torch
    return {"float32": (torch.float32, jnp.float32),
            "bfloat16": (torch.bfloat16, jnp.bfloat16)}[name]


def set_compute(monkeypatch, name: str) -> None:
    """Set both packages' ``COMPUTE_DTYPE`` (as ``tests/test_torch_lm.py``
    does: float32 where tokens must be equal)."""
    from repro.models import layers as JL
    from repro_torch.models import layers
    tdt, jdt = lm_dtypes(name)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", tdt)
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jdt)


def ref_params(init_fn, jcfg, seed: int = 0):
    """The reference's init tree as writable numpy arrays."""
    import jax
    return jax.tree.map(np.array, init_fn(jcfg, jax.random.PRNGKey(seed)))


def assert_cache_close(got: dict, want: dict) -> None:
    """Every leaf of the port's cache against the reference's, within an
    absolute floor of 1e-5 of the leaf's largest magnitude (a key written
    to the bfloat16 cache and read back in the same step can round to the
    neighbouring bf16 value, which moves the later layers' values by
    float32 ulps of their largest entries; entries far below the largest,
    from cancellation, carry those ulps as large relative errors) plus,
    for bfloat16 leaves, one bf16 ulp (2^-7 relative: values one float32
    ulp apart can round to neighbouring bf16 numbers)."""
    import torch
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for name, w in want.items():
        g = got[name]
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, (name, g.shape, w.shape)
        assert g.dtype in (torch.float32, torch.bfloat16), (name, g.dtype)
        rtol = 2 ** -7 if g.dtype == torch.bfloat16 else 0
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def stub_inputs(cfg, batch: int, seed: int) -> dict:
    """The stubbed frontends' seeded float32 inputs of ``cfg``'s family:
    ``{"vision": [B, n_vision_tokens, d_vision]}`` for the VLM, ``{"frames":
    [B, n_audio_frames, d_audio]}`` for Whisper, else ``{}``."""
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (batch, cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.n_audio_frames, cfg.d_audio)).astype(np.float32)}
    return {}


def fill_cross_caches(jcfg, jp, jcache, extra: dict) -> dict:
    """The reference's decode cache with its cross caches filled from
    ``extra`` as ``tests/test_models_smoke.py`` fills them: Whisper's
    ``enc`` from ``whisper.encode``; the VLM's ``vis_k``/``vis_v`` as each
    site's ``wk``/``wv`` of the projected vision embeddings.  Other
    families' caches come back as they are."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    jcache = dict(jcache)
    if "frames" in extra:
        from repro.models import whisper as JW
        enc = JW.encode(jcfg, jp, jnp.asarray(extra["frames"]))
        jcache["enc"] = enc.astype(jcache["enc"].dtype)
    if "vision" in extra:
        vis = (jnp.asarray(extra["vision"]).astype(JL.COMPUTE_DTYPE)
               @ jp["vproj"].astype(JL.COMPUTE_DTYPE))
        vk, vv = [], []
        for i in range(jcfg.n_layers // jcfg.cross_attn_every):
            attn = jax.tree.map(lambda a: a[i], jp["cross"]["attn"])
            vk.append(vis @ attn["wk"].astype(vis.dtype))
            vv.append(vis @ attn["wv"].astype(vis.dtype))
        jcache["vis_k"] = jnp.stack(vk).astype(jcache["vis_k"].dtype)
        jcache["vis_v"] = jnp.stack(vv).astype(jcache["vis_v"].dtype)
    return jcache


def check_lm_parity(jmod, jcfg, params, model, cache_from_numpy, *,
                    batch: int = 2, seq: int = 16, prompt: int = 5,
                    steps: int = 6, seed: int = 3) -> None:
    """The port's ``model`` (holding the reference's ``params``) against
    ``jmod`` (a ``repro.models`` family module) in the current compute
    dtype (float32: set both with ``set_compute``), the VLM with seeded
    ``vision`` and Whisper with seeded ``frames`` (``stub_inputs``):

    * ``forward_logits`` on ``[batch, seq]`` seeded tokens against
      ``forward_train``, rtol 1e-5 / atol 1e-6;
    * the loss against ``loss_fn``, rtol 1e-4;
    * with the cross caches filled (``fill_cross_caches``), ``prompt``
      reference decode steps, then ``steps`` greedy steps, each
      taken by the port from the reference's cache of that step (carried
      across by ``cache_from_numpy``): the step's logits within rtol/atol
      1e-5, its greedy tokens equal, and every leaf of the cache the port
      wrote against the reference's (``assert_cache_close``).  Each step
      starts from the reference's state because a bfloat16 cache entry
      one float32 ulp apart can round to the neighbouring bf16 value (the
      conv history's entries, 6.1e-5 apart), which moves the next steps'
      logits by ~1e-5 in a free-running chain."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro_torch.models import zoo
    cfg = model.cfg
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    extra = stub_inputs(cfg, batch, seed)
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    got = zoo.forward_logits(cfg, model, {"tokens": torch.from_numpy(tokens),
                                          **textra})
    want = jax.jit(lambda p, t, e: jmod.forward_train(jcfg, p, t, *e))(
        jp, jnp.asarray(tokens), tuple(jextra.values()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        loss = zoo.build(cfg, "cpu").loss(model, {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels), **textra})
    jloss = jmod.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels), **jextra})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)

    decode = jax.jit(lambda p, c, t, pos: jmod.forward_decode(jcfg, p, c, t,
                                                              pos))
    jcache = fill_cross_caches(jcfg, jp,
                               jmod.init_cache(jcfg, batch, prompt + steps),
                               extra)
    for p in range(prompt):
        jl, jcache = decode(jp, jcache, jnp.asarray(tokens[:, p:p + 1]),
                            jnp.int32(p))
    with torch.no_grad():
        for pos in range(prompt, prompt + steps):
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            cache = cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                     device="cpu")
            tl, cache = model.forward_decode(
                cache, torch.from_numpy(np.array(jtok)), pos)
            jl, jcache = decode(jp, jcache, jtok, jnp.int32(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {pos}")
            np.testing.assert_array_equal(
                torch.argmax(tl, dim=-1).numpy(),
                np.asarray(jnp.argmax(jl, axis=-1)))
            assert_cache_close(cache, jcache)


def open_gates(params: dict, seed: int) -> dict:
    """The VLM's numpy params with every cross site's ``gate`` set from
    ``seed`` to a non-zero value (|gate| in [0.5, 1.5), either sign): at
    the reference's init the gates are 0 and the cross path adds nothing,
    so a test at the init alone holds nothing of it."""
    rng = np.random.default_rng(seed)
    gate = params["cross"]["gate"]
    params["cross"]["gate"] = (rng.uniform(0.5, 1.5, gate.shape)
                               * rng.choice([-1.0, 1.0], gate.shape)
                               ).astype(np.float32)
    return params


def assert_layout_matches(model, params: dict) -> None:
    """``convert.lm_leaves(model)``'s layout is the reference's pytree:
    its paths are ``params``' leaves in ``jax.tree`` flatten order, and
    ``lm_params_to_numpy(model)`` has ``params``' structure and values
    (``model`` holding ``params``)."""
    import jax
    from repro_torch import convert
    _, layout = convert.lm_leaves(model)
    want = [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(layout.paths) == want
    back = convert.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, ref)
