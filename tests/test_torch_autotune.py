"""The port's profile autotuner (``launch/autotune.py``) against
``repro.launch.autotune``.

* Synthetic traces: the reference test's seven ``TracedConfig`` cases,
  each trace built once by the reference's ``_trace`` helper and read by
  both packages as plain tuples.  Under the reference's roofline
  constants (patched into the port's ``launch/roofline.py`` for the
  comparison) the static wire bytes, ``violations()``, the fitted model,
  the floored candidate grid, every ``Prediction`` and the whole ranking
  equal the reference's exactly; under the port's own H100 constants the
  anchor stays exact and every prediction positive, finite and
  replay-identical.
* The fallback mapping of ``autotune_gcn`` with a patched
  ``_instrumented_run``: corrupted, short, dropping and slow traces are
  rejected, a clean one accepted.
* The live differential: the port's ``_instrumented_run`` on the CPU,
  fed the reference's draws, records ``TraceRecord``s equal to the
  reference's in every field but ``wall_time_s`` (W = 4 sharded device
  store, W = 4 sharded host store, W = 1 tiered), the reference's side in
  ONE forced-4-device subprocess.
* The launcher: ``--autotune --autotune-steps 2`` warns, falls back to
  the ladders and trains to the end; a long enough window is accepted and
  skips the ladders; an accepted pick whose exchange drops requests in a
  trained batch is rolled back to the traced slack.

Every comparison is exact: no floating-point reduction order differs.
"""
import functools
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.autotune as jat  # noqa: E402
from _torch_parity import run_forced, torch_draws  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro_torch.core.config import TuneCandidate  # noqa: E402
from repro_torch.core.feature_cache import CacheConfig  # noqa: E402
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.graph.synthetic import (node_features,  # noqa: E402
                                         node_labels, powerlaw_graph)
from repro_torch.launch import autotune as at  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from test_autotune import _cache_cfg as _ref_cache_cfg  # noqa: E402
from test_autotune import _tc as _ref_tc  # noqa: E402
from test_autotune import _trace as _ref_trace  # noqa: E402

#: the reference test's seven traced configurations
CASES = {
    "sharded": {}, "tiered": dict(mode="tiered"),
    "replicated": dict(mode="replicated"),
    "host-cached": dict(mode="sharded", store="host"),
    "host-uncached": dict(mode=None, store="host"),
    "w1-uncached": dict(mode=None, w=1),
    "dense": dict(wire="dense", hit_cap=0),
}


def _port_trace(ref):
    """A reference ``Trace`` rebuilt as the port's, from plain tuples."""
    return at.Trace(config=at.TracedConfig(*tuple(ref.config)),
                    records=tuple(at.TraceRecord(*tuple(r))
                                  for r in ref.records))


def _port_cache_cfg(ref_cfg):
    return None if ref_cfg is None else CacheConfig(*tuple(ref_cfg))


@pytest.fixture(scope="module")
def traces():
    """Each case's reference trace (built once) and its port copy."""
    out = {}
    for name, kw in CASES.items():
        ref = _ref_trace(_ref_tc(**kw))
        out[name] = (ref, _port_trace(ref), _ref_cache_cfg(ref.config))
    return out


@pytest.fixture
def ref_constants(monkeypatch):
    """The port's roofline read the reference's constants (for the
    bit-for-bit comparison only; the port's own are the H100's)."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", jcfg.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", jcfg.HBM_BW)
    monkeypatch.setattr(roofline, "WIRE_BW", jcfg.ICI_BW)
    monkeypatch.setattr(roofline, "PCIE_BW", jcfg.PCIE_BW)


@pytest.mark.parametrize("name", list(CASES))
def test_synthetic_trace_matches_reference(traces, ref_constants, name):
    """Static wire bytes, violations, the fit, the floored grid, every
    prediction and the ranking equal the reference's, field for field."""
    ref, got, ref_cfg = traces[name]
    tc, jtc = got.config, ref.config
    cand = tc.candidate()
    assert tuple(cand) == tuple(jtc.candidate())
    assert at.static_wire_bytes(tc, cand) == jat.static_wire_bytes(
        jtc, jtc.candidate())
    assert got.violations() == ref.violations() == ()
    assert got.warm_records() == ref.warm_records()
    model, jmodel = at.CostModel.fit(got), jat.CostModel.fit(ref)
    assert tuple(model) == tuple(jmodel)
    floors = at.observed_floors(got)
    assert floors == jat.observed_floors(ref)
    grid = at.candidate_grid(tc, _port_cache_cfg(ref_cfg), floors=floors)
    jgrid = jat.candidate_grid(jtc, ref_cfg, floors=floors)
    assert grid and [tuple(c) for c in grid] == [tuple(c) for c in jgrid]
    for c, jc in zip(grid, jgrid):
        assert at.static_wire_bytes(tc, c) == jat.static_wire_bytes(jtc, jc)
    best, ranked = at.search(model, grid)
    jbest, jranked = jat.search(jmodel, jgrid)
    assert len(ranked) == len(jranked)
    for p, jp in zip(ranked, jranked):
        assert tuple(p.candidate) == tuple(jp.candidate)
        assert tuple(p)[1:] == tuple(jp)[1:], (p, jp)
    assert best == jbest
    # the open (unfloored) grid and the default search agree too
    open_grid = at.candidate_grid(tc, _port_cache_cfg(ref_cfg))
    assert [tuple(c) for c in open_grid] == [
        tuple(c) for c in jat.candidate_grid(jtc, ref_cfg)]
    assert at.search(model)[1] == jat.search(jmodel)[1]


def test_violations_match_reference_per_corruption(traces, ref_constants):
    """Each corruption class of the reference test breaches the same
    identities, with the same messages, in both packages."""
    ref, _, _ = traces["host-cached"]
    r = ref.records[1]
    for kw in (dict(n_hits=-1), dict(wall_time_s=0.0),
               dict(wall_time_s=float("nan")),
               dict(n_local_hits=r.n_local_hits + 1),
               dict(n_unique=r.n_unique + 1),
               dict(n_requests=r.n_requests + 1),
               dict(probe_round_bytes=r.probe_round_bytes + 1),
               dict(host_gather_bytes=r.host_gather_bytes + 1),
               dict(n_l3_hits=r.n_requests + 5, n_unique=r.n_requests + 5)):
        bad = jat.Trace(config=ref.config, records=(
            ref.records[0], r._replace(**kw)) + ref.records[2:])
        got = _port_trace(bad)
        assert got.violations() == bad.violations() != ()
        with pytest.raises(at.TraceInconsistent):
            at.CostModel.fit(got)


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_fit_rejects_short_windows(steps):
    """Windows shorter than MIN_TRACE_STEPS refuse to fit."""
    with pytest.raises(at.TraceTooShort):
        at.CostModel.fit(_port_trace(_ref_trace(_ref_tc(), steps=steps)))


@pytest.mark.parametrize("name", list(CASES))
def test_h100_constants_anchor_exact_and_finite(traces, name):
    """Under the port's own constants: the anchor reproduces the warm
    sums, the measured bytes and the traced mean step time exactly; every
    grid prediction is positive and finite; a replay of a second fit is
    bit-identical."""
    ref, got, ref_cfg = traces[name]
    tc = got.config
    model = at.CostModel.fit(got)
    warm = got.warm_records()
    p = model.predict(tc.candidate())
    assert p.n_hits == sum(r.n_hits for r in warm)
    assert p.n_l1_hits == sum(r.n_l1_hits for r in warm)
    assert p.n_l3_hits == sum(r.n_l3_hits for r in warm)
    assert p.n_misses == sum(r.n_misses for r in warm)
    assert p.n_distinct == sum(r.n_distinct() for r in warm)
    assert p.step_time_s == model.wall_mean_s
    probe, gather, _ = at.static_wire_bytes(tc, tc.candidate())
    assert (p.probe_round_bytes, p.host_gather_bytes) == (probe, gather)
    grid = at.candidate_grid(tc, _port_cache_cfg(ref_cfg),
                             floors=at.observed_floors(got))
    again = at.CostModel.fit(_port_trace(ref))
    for cand in grid:
        a, b = model.predict(cand), again.predict(cand)
        assert a.step_time_s > 0.0 and math.isfinite(a.step_time_s)
        assert a.cost_s > 0.0 and math.isfinite(a.cost_s)
        assert a == b
    assert at.search(model, grid) == at.search(again, grid)
    if tc.store == "host":
        assert p.cost_s >= p.host_gather_bytes / roofline.PCIE_BW


def test_with_candidate_applies_every_knob():
    """``ModelConfig.with_candidate`` swaps exactly the searched knobs and
    re-validates; ``candidate_cache_cfg`` the cache half."""
    cfg = train.get_config("graphgen-gcn")
    cand = TuneCandidate((20, 40), 1024, 0, 2, 33, 1.5)
    new = cfg.with_candidate(cand)
    assert (new.fanouts, new.cache_rows, new.cache_assoc, new.cache_hit_cap,
            new.capacity_slack) == ((20, 40), 1024, 2, 33, 1.5)
    assert (new.gcn_hidden, new.cache_mode) == (cfg.gcn_hidden,
                                                cfg.cache_mode)
    with pytest.raises(ValueError):
        cfg.with_candidate(cand._replace(assoc=3))
    base = CacheConfig.from_model(cfg)
    cc = at.candidate_cache_cfg(base, cand)
    assert (cc.n_rows, cc.assoc, cc.hit_cap, cc.mode) == (1024, 2, 33,
                                                          base.mode)


def _run_autotune(monkeypatch, traces, **kw):
    """``autotune_gcn`` against canned port traces: the first feeds the
    fit, the rest play the validator's windows (the last repeats)."""
    queue = list(traces)
    monkeypatch.setattr(
        at, "_instrumented_run",
        lambda device, part, feats, labels, tc, cache_cfg, probes, group:
            queue.pop(0) if len(queue) > 1 else queue[0])
    tc = _ref_tc()
    return at.autotune_gcn(
        "cpu", types.SimpleNamespace(n_workers=tc.n_workers), np.zeros(
            (64, tc.feat_dim), np.float32), None, fanouts=tc.fanouts,
        cache_cfg=_port_cache_cfg(_ref_cache_cfg(tc)),
        feature_store=tc.store, batch_per_worker=tc.batch_per_worker,
        seeds_for=lambda t: None, draws_for=lambda fo: lambda t, w, b: None,
        slack=tc.capacity_slack, **kw)


def _clean():
    return _port_trace(_ref_trace(_ref_tc()))


def test_corrupted_trace_is_rejected(monkeypatch):
    tr = _clean()
    bad = at.Trace(config=tr.config, records=(
        tr.records[0]._replace(probe_round_bytes=1),) + tr.records[1:])
    res = _run_autotune(monkeypatch, [bad])
    assert res.accepted is False and "TraceInconsistent" in res.reason
    assert res.candidate is None


def test_short_trace_degrades_to_ladders(monkeypatch):
    res = _run_autotune(monkeypatch,
                        [_port_trace(_ref_trace(_ref_tc(), steps=2))])
    assert res.accepted is False and "TraceTooShort" in res.reason


def test_validator_rejects_a_dropping_pick(monkeypatch):
    vt = _clean()
    vt = at.Trace(config=vt.config, records=(
        vt.records[0]._replace(n_dropped=3),) + vt.records[1:])
    res = _run_autotune(monkeypatch, [_clean(), vt])
    assert res.accepted is False
    assert "validator rejected" in res.reason and "dropped=3" in res.reason
    assert res.candidate is not None
    assert len(res.picks) == 3 and not any(p.accepted for p in res.picks)
    assert all(p.n_dropped == 3 for p in res.picks)


def test_validator_rejects_a_slow_pick(monkeypatch):
    res = _run_autotune(monkeypatch, [_clean(), _clean()],
                        validator_ratio=1e-9)
    assert res.accepted is False and "validator rejected" in res.reason
    assert res.measured_step_s > 0.0


def test_clean_run_is_accepted(monkeypatch):
    res = _run_autotune(monkeypatch, [_clean(), _clean()])
    assert res.accepted is True and res.reason == "accepted"
    assert res.candidate == res.prediction.candidate
    assert res.measured_step_s == pytest.approx(2e-3)
    assert [p.accepted for p in res.picks] == [True]


# ---------------------------------------------------------------------------
# the live differential against the reference (one subprocess)
# ---------------------------------------------------------------------------

#: the reference differential test's shape; each cell is (W, store, cache)
N, DIM, B, FANOUTS, STEPS = 2000, 16, 8, (3, 2), 8
LIVE = {
    "sharded": (4, "device", dict(n_rows=256, admit=1, assoc=2,
                                  mode="sharded", wire="compact", hit_cap=0)),
    "host": (4, "host", dict(n_rows=256, admit=1, assoc=2, mode="sharded",
                             wire="compact", hit_cap=0, store="host")),
    "tiered": (1, "device", dict(n_rows=256, admit=1, assoc=2,
                                 mode="tiered", l1_rows=32, l1_promote=1)),
}

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
import repro.launch.autotune as at
from repro.core.balance import balance_table
from repro.core.feature_cache import CacheConfig
from repro.core.partition import partition_edges
from repro.graph.synthetic import powerlaw_graph, node_features, node_labels
from repro.launch.mesh import make_mesh

g = powerlaw_graph({n}, avg_degree=8, n_hot=3, hot_degree=400, seed=0)
X, Y = node_features({n}, {dim}), node_labels({n}, 5)
rngs = jax.random.split(jax.random.PRNGKey(1), {steps})
out = {{}}
for name, (w, store, kw) in {live!r}.items():
    mesh = make_mesh((w,), ("data",))
    part = partition_edges(g, w)
    table = balance_table(np.arange({n}), w, seed=0)
    cfg = CacheConfig(**kw).validated()
    tc = at._traced_config({fanouts!r}, w, {b}, {dim}, cfg, 1.0, store)
    probes = []
    for t in range({steps}):
        cols = (np.arange({b}) + t * {b}) % table.per_worker.shape[1]
        seeds = table.per_worker[:, cols]
        probes.append((jnp.asarray(seeds), rngs[t]))
        out[f"{{name}}_seeds{{t}}"] = seeds
        for l, (o, e) in enumerate(jax_round_draws(rngs[t], w, {b},
                                                   {fanouts!r})):
            out[f"{{name}}_offs{{t}}_{{l}}"] = o
            out[f"{{name}}_e{{t}}_{{l}}"] = e
    trace = at._instrumented_run(mesh, part, X, Y, tc, cfg, probes)
    assert trace.violations() == (), trace.violations()
    out[name + "_records"] = np.array([tuple(r)[:-1] for r in trace.records],
                                      np.int64)
np.savez({path!r}, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def reference_traces(tmp_path_factory):
    """The reference's three live traces and their draws, from ONE
    forced-4-device subprocess."""
    path = str(tmp_path_factory.mktemp("autotune") / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE.format(
        tests=os.path.dirname(__file__), n=N, dim=DIM, b=B, steps=STEPS,
        fanouts=FANOUTS, live=LIVE, path=path), devices=4)
    return np.load(path)


@pytest.mark.parametrize("name", list(LIVE))
def test_live_trace_matches_reference(reference_traces, name):
    """The port's instrumented run on the CPU, fed the reference's draws:
    every record equal in every field but ``wall_time_s``; the trace is
    consistent and its anchor prediction exact."""
    ref = reference_traces
    w, store, kw = LIVE[name]
    g = powerlaw_graph(N, avg_degree=8, n_hot=3, hot_degree=400, seed=0)
    cfg = CacheConfig(**kw).validated()
    tc = at._traced_config(FANOUTS, w, B, DIM, cfg, 1.0, store)
    probes = [(torch.from_numpy(ref[f"{name}_seeds{t}"]),
               torch_draws([(ref[f"{name}_offs{t}_{l}"],
                             ref[f"{name}_e{t}_{l}"])
                            for l in range(len(FANOUTS))]))
              for t in range(STEPS)]
    trace = at._instrumented_run("cpu", partition_edges(g, w),
                                 node_features(N, DIM), node_labels(N, 5),
                                 tc, cfg, probes)
    got = np.array([tuple(r)[:-1] for r in trace.records], np.int64)
    want = ref[name + "_records"]
    assert got.shape == want.shape == (STEPS, len(at.TraceRecord._fields) - 1)
    for f, a, b in zip(at.TraceRecord._fields, got.T, want.T):
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: {f}")
    assert trace.violations() == ()
    assert all(r.wall_time_s > 0 for r in trace.records)
    rec = trace.records
    if name == "host":
        assert all(r.host_gather_bytes > 0 for r in rec)
    else:
        assert sum(r.n_hits for r in rec) > 0
    if name == "tiered":
        assert sum(r.n_l1_hits for r in rec) > 0
    model = at.CostModel.fit(trace)
    p = model.predict(tc.candidate())
    warm = trace.warm_records()
    assert p.n_hits == sum(r.n_hits for r in warm)
    assert p.step_time_s == model.wall_mean_s
    assert all(r.host_gather_bytes == w * p.host_gather_bytes for r in rec)


def test_host_trace_drains_the_gather_on_early_exit():
    """A host window whose telemetry breaks the tier-sum identity ends
    early and still drains the gather it issued."""
    issued = []

    class Handle:
        def __init__(self):
            self.landed = False

        def rows(self):
            self.landed = True
            return torch.zeros((1, 1, 4))

    class Store:
        def issue(self, ids):
            issued.append(Handle())
            return issued[-1]

    z = torch.zeros(1, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)

    def gen_fn(device_args, seeds, draws):
        from repro_torch.core.feature_cache import CacheStats
        from repro_torch.core.generation import FetchStats
        req = types.SimpleNamespace(ids=z)
        return None, req, (FetchStats(one, z, z, z, z),
                           CacheStats(n_hits=one, n_misses=z, n_inserted=z,
                                      bytes_saved=z, n_local_hits=z,
                                      n_shard_hits=z, n_l1_hits=z,
                                      n_probe_demoted=z, probe_hit_peak=z,
                                      n_l3_hits=z))

    tc = at.TracedConfig(fanouts=(2,), n_workers=1, batch_per_worker=1,
                         feat_dim=4, store="host")
    trace = at.record_trace(gen_fn, (torch.zeros(1),), [(None, None)] * 5,
                            tc, store=Store())
    assert len(trace.records) == 1 and len(issued) == 1
    assert issued[0].landed


def test_train_autotune_short_window_warns_and_falls_back(capsys, tmp_path):
    """``--autotune`` with fewer than MIN_TRACE_STEPS steps falls back to
    the calibration ladders with a warning and trains to the end."""
    train.main(["--arch", "graphgen-gcn", "--smoke", "--device", "cpu",
                "--workers", "4", "--steps", "3", "--nodes", "2000",
                "--batch-per-worker", "8", "--autotune", "--autotune-steps",
                "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "falling back to the calibration ladders" in out
    assert "TraceTooShort" in out
    assert "capacity_slack auto-sized" in out
    assert "trained 3 steps" in out


def test_train_autotune_accepts_and_skips_the_ladders(capsys, tmp_path,
                                                     monkeypatch):
    """A long enough window at W = 1 (no drop or demotion is possible
    there) is accepted: the candidate is applied, no ladder runs, and the
    run trains to the end with the candidate's fanouts.  The validator's
    time bound is widened here so that host-clock jitter of a loaded test
    machine cannot reject the pick (the bound itself is held by
    ``test_validator_rejects_a_slow_pick``)."""
    monkeypatch.setattr(at, "autotune_gcn", functools.partial(
        at.autotune_gcn, validator_ratio=1e9))
    args = train.parse_args([
        "--arch", "graphgen-gcn-deep", "--smoke", "--device", "cpu",
        "--steps", "3", "--nodes", "2000", "--batch-per-worker", "8",
        "--autotune", "--autotune-steps", "4", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)])
    res = train.train_gcn(args)
    out = capsys.readouterr().out
    at_res = res["autotune"]
    assert at_res.accepted, at_res.reason
    assert "autotune: accepted" in out and res["ladders"] == []
    assert res["fanouts"] == at_res.candidate.fanouts
    assert res["capacity_slack"] == at_res.candidate.capacity_slack
    cc, cand = res["cache_cfg"], at_res.candidate
    assert (cc.n_rows, cc.l1_rows, cc.assoc) == (cand.cache_rows,
                                                 cand.l1_rows, cand.assoc)
    assert len(at_res.trace.records) == 4
    assert at_res.trace.violations() == ()
    assert len(res["losses"]) == 3 and all(map(math.isfinite,
                                                res["losses"]))


def test_autotuned_drop_rolls_back_to_the_traced_slack(capsys, tmp_path,
                                                        monkeypatch):
    """An accepted pick whose exchange drops requests in a trained batch
    (slack 0.25 at W = 4) is rolled back: the batch is regenerated at the
    traced slack, which the run keeps, and no trained batch drops."""
    traced = at.TracedConfig(fanouts=(4, 3), n_workers=4, batch_per_worker=8,
                             feat_dim=16, mode="sharded", cache_rows=256,
                             assoc=4, capacity_slack=2.0)
    pick = TuneCandidate((4, 3), 256, 0, 4, 0, 0.25)
    monkeypatch.setattr(at, "autotune_gcn", lambda *a, **k: at.AutotuneResult(
        True, "accepted", candidate=pick, trace=at.Trace(traced, ())))
    res = train.train_gcn(train.parse_args([
        "--arch", "graphgen-gcn", "--smoke", "--device", "cpu", "--workers",
        "4", "--steps", "4", "--nodes", "2000", "--batch-per-worker", "8",
        "--autotune", "--log-every", "1", "--ckpt-dir", str(tmp_path)]))
    out = capsys.readouterr().out
    assert "the autotuned exchange dropped requests" in out
    assert res["autotune_rollback"] == 0 and res["n_dropped"] == 0
    assert res["capacity_slack"] == 0.25 and res["ladders"] == []

