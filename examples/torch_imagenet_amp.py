"""End-to-end AMP ResNet training on the PyTorch port, the canonical
example (counterpart of examples/imagenet_amp.py, ≡ apex's
examples/imagenet/main_amp.py): ResNet-50, AMP opt levels O0-O3, the
data-parallel step, FusedSGD, and the images/sec Speed meter.

Synthetic data made on the device from a seeded generator: a pool of
max(2 x batch, 256) N(0, 1) images and uniform labels, one upload-free
copy.  Each iteration draws its batch by the host runtime's epoch
shuffle (`csrc.shuffle_indices(pool, iteration)`, the JAX example's
bits), sent from pinned memory without a sync, and gathers the images
on the device.  `--save DIR` writes the optimizer, model and loss-scaler
state through `checkpoint.save_checkpoint` (the single-file format).
Under the port's launcher each rank takes its dp share of the global
batch.

Run (the card; `--device cpu` for the plain versions):
  python examples/torch_imagenet_amp.py --opt-level O1 --batch-size 64 \\
      --arch resnet50 --iters 100
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from apex_tpu_torch import amp  # noqa: E402
from apex_tpu_torch.checkpoint import save_checkpoint  # noqa: E402
from apex_tpu_torch.csrc import shuffle_indices  # noqa: E402
from apex_tpu_torch.models.resnet import ResNet  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss  # noqa: E402
from apex_tpu_torch.optimizers import FusedSGD  # noqa: E402
from apex_tpu_torch.parallel import ddp  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.parallel.multiproc import init_from_env  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--batch-size", type=int, default=64,
                   help="global batch size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--save", default=None)
    p.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs the plain versions (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"losses": [...], "img_per_s": [...] a print window}."""
    args = parse(argv)
    dev = resolve_device(args.device)
    joined = init_from_env(args.device)
    if dist.is_initialized() and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    M.destroy_model_parallel()
    M.initialize_model_parallel()
    group = M.data_parallel_group()
    dp, rank = M.group_size(group), M.group_rank(group)
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(f"devices: {world}  mesh dp={dp}")
    if args.batch_size % dp:
        raise SystemExit(f"--batch-size {args.batch_size} does not split "
                         f"over dp={dp}")
    local = args.batch_size // dp

    model = ResNet(args.arch, num_classes=args.num_classes)
    params, mstate = model.init(seed=0, device=dev)
    amp_state = amp.initialize(opt_level=args.opt_level, device=dev)
    if amp_state.policy.param_dtype != torch.float32:
        params = amp.convert_network(params, amp_state.policy.param_dtype)

    def loss_fn(p, ms, batch):
        x, y = batch
        logits, new_ms = model.apply(p, ms, x, training=True)
        return torch.mean(softmax_cross_entropy_loss(logits.float(), y)), \
            new_ms

    opt = FusedSGD(lr=args.lr, momentum=args.momentum,
                   weight_decay=args.weight_decay)
    state = opt.init(params)
    del params
    scaler = amp_state.loss_scalers[0]
    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True, device=dev)

    n_samples = max(args.batch_size * 2, 256)
    gen = torch.Generator(device=dev).manual_seed(0)
    dataset = torch.randn((n_samples, args.image_size, args.image_size, 3),
                          generator=gen, device=dev)
    labels_all = torch.randint(0, args.num_classes, (n_samples,),
                               generator=gen, device=dev)

    losses, rates = [], []
    window = []
    t0 = time.perf_counter()
    for it in range(args.iters):
        order = shuffle_indices(n_samples, it)[: args.batch_size]
        idx = torch.from_numpy(order[rank * local:(rank + 1) * local])
        if dev.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(dev, non_blocking=True)
        x = dataset.index_select(0, idx)           # device-side gather
        y = labels_all.index_select(0, idx)
        state, scaler, mstate, loss = step(state, scaler, mstate, (x, y))
        window.append(loss)
        if (it + 1) % args.print_freq == 0:
            losses += [float(v) for v in window]
            window = []
            dt = (time.perf_counter() - t0) / args.print_freq
            rates.append(args.batch_size / dt)
            # ≡ the Speed meter (main_amp.py:386-397)
            print(f"iter {it+1}  loss {losses[-1]:.4f}  "
                  f"Speed {args.batch_size / dt:.1f} img/sec  "
                  f"time/iter {dt*1000:.1f} ms  "
                  f"loss_scale {float(scaler.scale):.0f}")
            t0 = time.perf_counter()
    losses += [float(v) for v in window]

    if args.save:
        save_checkpoint(args.save, {
            "opt_state": state, "model_state": mstate,
            "amp": amp.state_dict(amp_state)}, use_orbax=False)
        print(f"saved to {args.save}")
    M.destroy_model_parallel()
    if joined:
        dist.destroy_process_group()
    return {"losses": losses, "img_per_s": rates}


if __name__ == "__main__":
    main()
