"""One rank of a data-parallel ``fit`` of the port, for
tests/test_torch_port_parallel.py (run as a script, in a fresh
interpreter: it imports torch and the port only, never JAX).

    python tests/torch_port_dp_worker.py <job.json> <rank>

The job names the world size, the rendezvous file, the ``TrainConfig``
fields (its ``model`` as a dict), per rank, the step at which the rank
sends itself SIGTERM (-1: none), and the rank whose checkpoint writes
fail with ENOSPC (-1: none).  The rank joins the gloo group on the
CPU, runs ``fit`` and writes ``<out>/rank<r>.json`` (the result's epoch
losses, checkpoint, step, preempted flag) and ``<out>/rank<r>.pt`` (the
final params).
"""

import errno
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ncnet_tpu_torch import config as tcfg  # noqa: E402
from ncnet_tpu_torch import training as ttrain  # noqa: E402
from ncnet_tpu_torch.models import checkpoint as tckpt  # noqa: E402
from ncnet_tpu_torch.parallel import distributed as pdist  # noqa: E402
from ncnet_tpu_torch.utils import faults  # noqa: E402


def main(job_path: str, rank: int) -> None:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    pdist.initialize_distributed(
        device="cpu", init_method="file://" + job["rendezvous"],
        world_size=job["world"], rank=rank, timeout_s=job["timeout_s"])
    train = dict(job["train"])
    model = dict(train.pop("model"))
    for key in ("ncons_kernel_sizes", "ncons_channels"):
        model[key] = tuple(model[key])
    config = tcfg.TrainConfig(model=tcfg.ModelConfig(**model), **train)
    step = job["sigterm_at_step"][rank]
    if step >= 0:
        faults.install(faults.FaultPlan(sigterm_at_step=step))
    if job.get("fail_save_rank", -1) == rank:
        def no_space(*args, **kwargs):
            raise OSError(errno.ENOSPC, "No space left on device")

        tckpt.save_tree = no_space
    res = ttrain.fit(config, progress=False, device="cpu")
    out = job["out"]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"train_loss": [float(x) for x in res["train_loss"]],
                   "test_loss": [float(x) for x in res["test_loss"]],
                   "checkpoint": res["checkpoint"],
                   "step": int(res["state"].step),
                   "preempted": bool(res["preempted"]),
                   "world": pdist.world_size()}, f)
    torch.save(tckpt.cpu_tree(res["state"].params),
               os.path.join(out, f"rank{rank}.pt"))
    pdist.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
