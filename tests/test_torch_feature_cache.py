"""Parity of the port's feature cache with ``repro``: the uint32 hashes,
the bitmap codec and payload compaction, the probe, and cache_insert
sequences on adversarial streams — every state array bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import as_u32, assert_state_equal  # noqa: E402
from repro.core import feature_cache as jfc  # noqa: E402
from repro_torch.core import feature_cache as tfc  # noqa: E402

_EDGE_IDS = np.asarray([-1, 0, 1, 2, 7, 2**31 - 1, 2**31 - 2, 2**31 - 17,
                        2**30, -2, -(2**31)], np.int32)


@pytest.mark.parametrize("n_sets", [1, 2, 64, 1024, 2**20])
def test_hash_slots_matches_uint32_wraparound(n_sets):
    """Set hash on -1, 0, ids near 2^31 and random ids: equal to the
    reference's uint32 multiply-and-shift."""
    rng = np.random.default_rng(n_sets)
    ids = np.concatenate([_EDGE_IDS, rng.integers(-2**31, 2**31 - 1, 500,
                                                  dtype=np.int64)
                          .astype(np.int32)])
    got = tfc.hash_slots(torch.from_numpy(ids), n_sets).numpy()
    want = np.asarray(jfc.hash_slots(jnp.asarray(ids), n_sets))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
def test_shard_of_matches(w):
    """Shard routing hash, same edge ids."""
    rng = np.random.default_rng(w)
    ids = np.concatenate([_EDGE_IDS, rng.integers(0, 2**31 - 1, 500)
                          .astype(np.int32)])
    np.testing.assert_array_equal(
        tfc.shard_of(torch.from_numpy(ids), w).numpy(),
        np.asarray(jfc.shard_of(jnp.asarray(ids), w)))


def test_hash_rejects_non_power_of_two():
    """A non-power-of-two set count raises, as in the reference."""
    with pytest.raises(ValueError):
        tfc.hash_slots(torch.zeros(3, dtype=torch.int32), 3)


@pytest.mark.parametrize("shape", [(1,), (31,), (32,), (33,), (3, 100), (2, 2, 64)])
def test_bitmap_codec_matches(shape):
    """pack/unpack: the port's int32 words are the reference's uint32 words
    bit for bit, and unpacking inverts packing."""
    rng = np.random.default_rng(sum(shape))
    hit = rng.random(shape) < 0.4
    hit.reshape(-1)[-1] = True          # exercise bit 31 / the sign bit
    got = tfc.pack_hit_bitmap(torch.from_numpy(hit))
    want = jfc.pack_hit_bitmap(jnp.asarray(hit))
    np.testing.assert_array_equal(as_u32(got.numpy()), as_u32(want))
    np.testing.assert_array_equal(
        tfc.unpack_hit_bitmap(got, shape[-1]).numpy(), hit)
    with pytest.raises(ValueError):
        tfc.unpack_hit_bitmap(got, shape[-1] + 32)


@pytest.mark.parametrize("hit_cap", [0, 1, 5, 64, 1000])
def test_compact_expand_match(hit_cap):
    """Holder-side compaction and requester-side expansion equal the
    reference's, including demotion past hit_cap."""
    rng = np.random.default_rng(hit_cap)
    hit = rng.random((3, 64)) < 0.3
    rows = rng.standard_normal((3, 64, 5)).astype(np.float32)
    kept, payload = tfc.compact_hit_rows(torch.from_numpy(hit),
                                         torch.from_numpy(rows), hit_cap)
    jk, jp = jfc.compact_hit_rows(jnp.asarray(hit), jnp.asarray(rows), hit_cap)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tfc.expand_hit_rows(kept, payload).numpy(),
        np.asarray(jfc.expand_hit_rows(jk, jp)))


def _to_jax(state):
    return jfc.FeatureCache(*(jnp.asarray(a.numpy()) for a in state))


def _fresh(cfg, d):
    return tfc.init_cache_state(cfg, d, 1, device="cpu").worker(0)


def _streams(n_sets):
    """The adversarial offer streams of tests/test_feature_cache.py plus a
    same-set overflow: all-duplicate, all-distinct, single-id, empty, and
    more distinct same-set ids than any set has ways."""
    rng = np.random.default_rng(11)
    pool = rng.choice(10_000, size=4000, replace=False).astype(np.int32)
    sets = np.asarray(jfc.hash_slots(jnp.asarray(pool), n_sets))
    same_set = pool[sets == sets[0]][:12]
    return [
        np.full(40, 7, np.int32),
        np.arange(48, dtype=np.int32),
        np.asarray([5], np.int32),
        np.zeros(0, np.int32),
        same_set,
        np.concatenate([same_set, same_set[:5], np.arange(30, dtype=np.int32)]),
        rng.integers(0, 80, 120).astype(np.int32),
    ]


@pytest.mark.parametrize("assoc,admit", [(1, 1), (4, 2)])
def test_insert_sequences_bit_exact(assoc, admit):
    """Two passes over every adversarial stream, with a random ``should``
    mask: after each insert every state array equals the reference's, and
    so does the inserted count; probes of the stream then agree too."""
    c, d = 32, 3
    cfg = tfc.CacheConfig(c, admit=admit, assoc=assoc).validated()
    jcfg = jfc.CacheConfig(c, admit=admit, assoc=assoc).validated()
    state = _fresh(cfg, d)
    jstate = _to_jax(state)
    jinsert = jax.jit(jfc.cache_insert, static_argnames=("cfg",))
    jprobe = jax.jit(jfc.cache_probe, static_argnames=("cfg",))
    rng = np.random.default_rng(assoc * 10 + admit)
    for _ in range(2):
        for ids in _streams(cfg.n_sets):
            rows = (ids[:, None] * 10.0 + np.arange(d)).astype(np.float32)
            should = rng.random(ids.shape[0]) < 0.85
            state, n = tfc.cache_insert(state, torch.from_numpy(ids),
                                        torch.from_numpy(rows),
                                        torch.from_numpy(should), cfg)
            jstate, jn = jinsert(jstate, jnp.asarray(ids), jnp.asarray(rows),
                                 jnp.asarray(should), cfg=jcfg)
            assert_state_equal(jstate, state)
            assert int(n) == int(jn)
            hit, got = tfc.cache_probe(state, torch.from_numpy(ids), cfg=cfg)
            jhit, jgot = jprobe(jstate, jnp.asarray(ids), cfg=jcfg)
            np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
            np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_probe_valid_mask_and_layout_check():
    """``valid`` masks hits and rows; a mismatched layout raises."""
    cfg = tfc.CacheConfig(16, admit=1, assoc=2).validated()
    state = _fresh(cfg, 2)
    ids = torch.arange(10, dtype=torch.int32)
    state, _ = tfc.cache_insert(state, ids, torch.ones(10, 2),
                                torch.ones(10, dtype=torch.bool), cfg)
    valid = torch.arange(10) < 4
    hit, rows = tfc.cache_probe(state, ids, valid, cfg=cfg)
    assert not hit[4:].any() and (rows[4:] == 0).all()
    with pytest.raises(ValueError, match="mismatched"):
        tfc.cache_probe(state, ids, cfg=tfc.CacheConfig(32))


def test_cache_config_views_match():
    """from_model, serve_view and validated agree with the reference."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    for name in ("graphgen-gcn", "graphgen-sage", "graphgen-gcn-deep"):
        a = tfc.CacheConfig.from_model(tget(name))
        b = jfc.CacheConfig.from_model(jget(name))
        assert tuple(a) == tuple(b)
        assert tuple(a.serve_view()) == tuple(b.serve_view())
    with pytest.raises(ValueError, match="frozen"):
        tfc.CacheConfig(128, frozen=True, store="host").validated()
