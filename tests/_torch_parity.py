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
