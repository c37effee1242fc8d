"""Parity of the port's data layer with ``repro``: the synthetic graph,
features, labels, the edge partition and the config rounding — all
exact — plus the port's import isolation (no jax, no ``repro``)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.graph import synthetic as jax_synth  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.graph import synthetic  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("n,deg,hot,seed", [(300, 6.0, 3, 0), (1000, 10.0, 1, 5)])
def test_graph_features_labels_bit_equal(n, deg, hot, seed):
    """Same seed -> the same CSR, feature table and labels, byte for byte."""
    g = synthetic.powerlaw_graph(n, avg_degree=deg, n_hot=hot, seed=seed)
    gj = jax_synth.powerlaw_graph(n, avg_degree=deg, n_hot=hot, seed=seed)
    assert g.indptr.tobytes() == gj.indptr.tobytes()
    assert g.indices.tobytes() == gj.indices.tobytes()
    assert (synthetic.node_features(n, 16, seed).tobytes()
            == jax_synth.node_features(n, 16, seed).tobytes())
    assert (synthetic.node_labels(n, 5, seed).tobytes()
            == jax_synth.node_labels(n, 5, seed).tobytes())


@pytest.mark.parametrize("w,strategy", [(1, "by_edge_hash"), (4, "by_edge_hash"),
                                        (4, "by_src_block")])
def test_partition_edges_bit_equal(w, strategy):
    """Every stacked array of the partition is equal, and so is the
    balance figure."""
    g = synthetic.powerlaw_graph(400, avg_degree=6, n_hot=2, seed=1)
    p = partition.partition_edges(g, w, strategy)
    pj = jax_partition.partition_edges(g, w, strategy)
    for name in ("indptr", "indices", "n_local"):
        assert getattr(p, name).tobytes() == getattr(pj, name).tobytes(), name
    assert p.n_nodes == pj.n_nodes and p.n_workers == pj.n_workers == w
    assert p.edge_balance() == pj.edge_balance()


@pytest.mark.parametrize("rows,l1", [(0, 0), (1, 0), (1000, 0), (4096, 0),
                                     (4097, 100)])
def test_config_rounding_matches(rows, l1):
    """cache_rows and cache_l1_rows round up to a power of two exactly as
    the reference's ModelConfig does."""
    kw = dict(name="x", family="gcn", cache_rows=rows, cache_l1_rows=l1)
    a, b = ModelConfig(**kw), JaxModelConfig(**kw)
    assert (a.cache_rows, a.cache_l1_rows) == (b.cache_rows, b.cache_l1_rows)


def test_registry_and_smoke_configs_match():
    """The three GCN configs and their smoke variants carry the reference's
    values in every field the port has."""
    for name in ("graphgen-gcn", "graphgen-sage", "graphgen-gcn-deep"):
        for a, b in ((get_config(name), jax_get_config(name)),
                     (smoke_config(get_config(name)),
                      jax_smoke_config(jax_get_config(name)))):
            for f in dataclasses.fields(a):
                assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)


def test_config_validation_rejects_bad_policy():
    """Bad cache knobs raise at construction, as in the reference."""
    for kw in (dict(cache_rows=-1), dict(cache_assoc=3),
               dict(cache_rows=2, cache_assoc=4), dict(cache_mode="x"),
               dict(cache_wire="x"), dict(cache_hit_cap=-1)):
        with pytest.raises(ValueError):
            ModelConfig(name="x", family="gcn", **kw)


def test_port_imports_no_jax_and_no_repro():
    """A fresh interpreter importing the serving entry point and the kernel
    dispatch has neither jax nor the reference package loaded."""
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')"
        " or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert "BAD []" in proc.stdout
