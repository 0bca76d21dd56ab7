"""Minimal data-parallel training on the PyTorch port (counterpart of
examples/simple_distributed.py, ≡ apex's examples/simple/distributed):
the smallest DDP-equivalent program.

A linear regression on the JAX example's data shapes (64 samples of 8
features, the targets from a random true weight), 20 FusedSGD(lr=0.2)
steps through `parallel.ddp.make_train_step`: each rank takes its dp
share of the batch and the gradients are averaged over the dp group.
Under the port's launcher the world is its ranks (NCCL on the card,
gloo with `--device cpu`); a process group its caller already set up is
used as it is; otherwise the world is this process.  The data come from
torch Generators seeded 0 and 1 (the JAX example's from PRNG keys 0 and
1).

    python examples/torch_simple_distributed.py [--device cpu]
    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \\
        examples/torch_simple_distributed.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedSGD  # noqa: E402
from apex_tpu_torch.parallel import ddp  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.parallel.multiproc import init_from_env  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs the plain versions (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the 20 losses (floats)."""
    a = parse(argv)
    dev = resolve_device(a.device)
    joined = init_from_env(a.device)
    if dist.is_initialized() and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    M.destroy_model_parallel()
    M.initialize_model_parallel()
    names, sizes = M.mesh_axes()
    print("mesh:", dict(zip(names, sizes)))
    group = M.data_parallel_group()
    dp, rank = M.group_size(group), M.group_rank(group)

    X = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    w_true = torch.randn((8, 1), generator=torch.Generator().manual_seed(1))
    Y = X @ w_true
    if 64 % dp:
        raise SystemExit(f"the batch of 64 does not split over dp={dp}")
    rows = slice(rank * 64 // dp, (rank + 1) * 64 // dp)
    batch = (X[rows].to(dev), Y[rows].to(dev))

    def loss_fn(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] - y) ** 2)

    opt = FusedSGD(lr=0.2)
    state = opt.init({"w": torch.zeros((8, 1), device=dev)})
    step = ddp.make_train_step(loss_fn, opt, device=dev)
    losses = []
    for i in range(20):
        state, _, loss = step(state, None, batch)
        losses.append(float(loss))
        if i % 5 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    print("final loss:", losses[-1])
    M.destroy_model_parallel()
    if joined:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
