"""``serve_lm`` over the LM's model axis (``--dist gloo --workers M``).

* One config of each LM family (dense smollm-135m, qwen3-moe-30b-a3b,
  deepseek-v2-236b, llama-3.2-vision-11b, whisper-small, mamba2-1.3b,
  zamba2-1.2b), smoke widths, ``--shard-heads``: every config served in
  ONE launch of two gloo processes on the CPU (``launch.mesh``),
  ``COMPUTE_DTYPE`` float32 in the ranks and here; both ranks' tokens
  equal ``--dist none``'s.  The heads split where they divide 2
  (whisper-small's 3 smoke heads and the SSM stay whole), the MoEs'
  experts split, decode takes the gather path.
* The CLI: ``python -m repro_torch.launch.serve ... --dist gloo
  --workers 2`` spawns its ranks, exits 0, and rank 0 alone prints the
  tokens and tok/s.
* ``--dist none --workers 2`` raises for an LM; ``train_lm`` refuses a
  model axis that does not divide its workers, and one without
  ``--dist``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh, serve, train  # noqa: E402
from repro_torch.models import layers  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_TESTS, "..", "src")
ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
         "llama-3.2-vision-11b", "whisper-small", "mamba2-1.3b",
         "zamba2-1.2b")


def _argv(arch):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen-len", "6", "--shard-heads"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_TESTS, _SRC, env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _serve_all(group, out):
    """A rank's share (``launch.mesh``'s target): ``serve_lm`` of every
    config over the group, tokens to ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    res = {}
    for arch in ARCHS:
        args = serve.parse_args(_argv(arch) + [
            "--dist", "gloo", "--workers", str(group.world)])
        res[arch] = serve.serve_lm(args, group=group)["tokens"]
    np.savez(os.path.join(out, f"rank{group.rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    rc = mesh.run("test_torch_serve_mesh:_serve_all", 2, device="cpu",
                  kwargs={"out": str(out)}, timeout_s=300, env=_env())
    assert rc == 0, f"the ranks exited {rc}"
    return [np.load(out / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_dist_tokens_equal_one_process(ranks, monkeypatch, arch):
    """Both ranks' greedy tokens equal the one-process run's (float32)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    want = serve.serve_lm(serve.parse_args(_argv(arch)))["tokens"]
    assert want.shape == (2, 6)
    for rank in ranks:
        np.testing.assert_array_equal(rank[arch], want)


def test_serve_lm_dist_cli():
    """``--dist gloo --workers 2`` through the CLI: two ranks, exit 0,
    and one line of tok/s (rank 0's)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "2", "--gen-len", "2", "--dist", "gloo",
         "--workers", "2", "--shard-heads"], capture_output=True, text=True, timeout=300,
        env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("over a model axis of 2 ranks") == 1


def test_lm_refuses_what_it_cannot_run():
    """``serve_lm --dist none --workers 2`` raises (the model axis needs a
    process per rank); ``train_lm`` refuses a model axis that does not
    divide ``--workers`` before it spawns a rank, and ``--model-axis``
    without ``--dist``."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu"]
    with pytest.raises(ValueError, match="process per rank"):
        serve.serve_lm(serve.parse_args(argv + ["--workers", "2"]))
    with pytest.raises(ValueError, match="must divide --workers 3"):
        train.main(argv + ["--dist", "gloo", "--workers", "3",
                           "--model-axis", "2"])
    with pytest.raises(ValueError, match="one process per rank"):
        train.main(argv + ["--workers", "2", "--model-axis", "2"])
