#!/usr/bin/env python3
"""What NCCL says to two ranks of one communicator on one card.

Starts two ranks through the port's launcher (``launch/mesh.py``'s
``spawn``), both on ``cuda:0``, each joining an NCCL process group and
summing one tensor; each prints the exception it gets (or the sum), and
NCCL's own warnings show with ``NCCL_DEBUG=WARN``.  This is why
``--dist nccl`` refuses more workers than visible cards, and why the
port's W > 1 on one card runs over gloo.  Card only, from the repository
root: ``python3 scripts/nccl_one_card.py`` (exits 0 whatever NCCL does;
the launcher ends the ranks after 90 s).
"""
import datetime
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank_main() -> None:
    """One rank: join on cuda:0 and sum a tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import ENV_STORE
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.environ[ENV_STORE]}",
            world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"[nccl one card] rank {rank}: all_reduce returned "
              f"{x.tolist()}", flush=True)
    except Exception as e:       # noqa: BLE001 - the message is the result
        print(f"[nccl one card] rank {rank}: {type(e).__name__}: {e}",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> None:
    """Launch the two ranks and report the launcher's code."""
    from repro_torch.launch import mesh
    if mesh.launched():
        rank_main()
        return
    import torch
    print(f"[nccl one card] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    env = dict(os.environ, NCCL_DEBUG="WARN")
    rc = mesh.spawn([os.path.abspath(__file__)], 2, 90, env)
    print(f"[nccl one card] launcher exit code {rc}", flush=True)


if __name__ == "__main__":
    main()
