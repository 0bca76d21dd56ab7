"""DCGAN under AMP on the PyTorch port — the multi-model,
multi-optimizer, multi-loss demo (counterpart of examples/dcgan_amp.py,
≡ apex's examples/dcgan/main_amp.py).

Two networks (G, D), two FusedAdam optimizers and THREE losses an
iteration (errD_real, errD_fake, errG), each with its own loss scaler:
`amp.initialize(params, opt_level, num_losses=3)`, the reference's
`amp.initialize([netD, netG], [optD, optG], num_losses=3)`.  Each of
D's two losses is unscaled by its own scaler before the gradients are
summed, so the scalers may diverge freely.

The networks are the JAX example's: G a 4x4 transposed-convolution
stack (BN + ReLU, tanh head), D a 4x4 stride-2 convolution stack (BN,
LeakyReLU(0.2)), the JAX package's HWIO weight layout and N(0, 0.02)
init, per-batch BN statistics in fp32.  The convolutions are cuDNN's
(the JAX example leaves them to XLA); the transposed ones are
`conv_transpose2d` on the spatially flipped kernel, which is
`lax.conv_transpose`'s (unflipped) arithmetic.  Synthetic data by
default (the reference's `--dataset fake`): uniform images in [-1, 1]
and N(0, 1) codes from seeded generators on the device.

Run (the card; `--device cpu` for the plain versions):
    python examples/torch_dcgan_amp.py --image-size 32 --iters 20
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from apex_tpu_torch import amp  # noqa: E402
from apex_tpu_torch.amp import scaler as scaler_lib  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.optimizers import flat as FL  # noqa: E402


# ---------------------------------------------------------------- models
def _conv_init(gen, kh, kw, cin, cout, device):
    # DCGAN init: N(0, 0.02) (main_amp.py weights_init)
    return (torch.randn((kh, kw, cin, cout), generator=gen) * 0.02).to(
        device)


def _bn_params(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn(x, p, eps=1e-5):
    """Per-batch BN over (N, H, W) of an NCHW fp32 tensor."""
    mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
    var = torch.var(x, dim=(0, 2, 3), keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _key(i):
    return f"l{i}"


class Generator:
    """z (N, nz, 1, 1) -> image (N, nc, S, S)."""

    def __init__(self, image_size=32, nz=100, ngf=64, nc=3):
        assert image_size in (32, 64)
        mult = image_size // 8  # 4 for 32, 8 for 64
        chain = [(nz, ngf * mult, 1)]
        while mult > 1:
            chain.append((ngf * mult, ngf * mult // 2, 2))
            mult //= 2
        chain.append((ngf, nc, 2))
        self.chain = chain

    def init(self, gen, device):
        params = {}
        for i, (cin, cout, _s) in enumerate(self.chain):
            p = {"w": _conv_init(gen, 4, 4, cin, cout, device)}
            if i < len(self.chain) - 1:
                p["bn"] = _bn_params(cout, device)
            params[_key(i)] = p
        return params

    def __call__(self, params, z, policy=None):
        compute = policy.cast_to_compute if policy else (lambda t: t)
        x = z
        for i, (_cin, _cout, s) in enumerate(self.chain):
            p = params[_key(i)]
            # HWIO -> (I, O, H, W), flipped: lax.conv_transpose's kernel
            w = compute(p["w"]).permute(2, 3, 0, 1).flip(2, 3)
            x = F.conv_transpose2d(compute(x), w, stride=s,
                                   padding=0 if i == 0 else 1)
            if i < len(self.chain) - 1:
                x = torch.relu(_bn(x.float(), p["bn"]))
            else:
                x = torch.tanh(x.float())
        return x


class Discriminator:
    """image -> logit; 4x4 stride-2 convolutions, LeakyReLU(0.2), BN."""

    def __init__(self, image_size=32, ndf=64, nc=3):
        mult, chain, cin, size = 1, [], nc, image_size
        while size > 4:
            chain.append((cin, ndf * mult, 2))
            cin, mult, size = ndf * mult, mult * 2, size // 2
        chain.append((cin, 1, 1))  # 4x4 VALID -> 1x1 logit
        self.chain = chain

    def init(self, gen, device):
        params = {}
        for i, (cin, cout, _s) in enumerate(self.chain):
            p = {"w": _conv_init(gen, 4, 4, cin, cout, device)}
            if 0 < i < len(self.chain) - 1:
                p["bn"] = _bn_params(cout, device)
            params[_key(i)] = p
        return params

    def __call__(self, params, x, policy=None):
        compute = policy.cast_to_compute if policy else (lambda t: t)
        last = len(self.chain) - 1
        for i, (_cin, _cout, s) in enumerate(self.chain):
            p = params[_key(i)]
            w = compute(p["w"]).permute(3, 2, 0, 1)      # HWIO -> OIHW
            x = F.conv2d(compute(x), w, stride=s, padding=0 if i == last
                         else 1)
            if i < last:
                if "bn" in p:
                    x = _bn(x.float(), p["bn"])
                x = F.leaky_relu(x.float(), 0.2)
        return x.reshape(x.shape[0]).float()  # logits


def bce_with_logits(logits, target):
    # stable BCEWithLogitsLoss ≡ nn.BCELoss(sigmoid) in the reference
    return torch.mean(torch.clamp_min(logits, 0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------- steps
def _params(opt, state, grad):
    leaves = FL.unflatten_leaves(state.params, opt.spec)
    if grad:
        leaves = [p.detach().requires_grad_(True) for p in leaves]
    return leaves, FL.tree_from_leaves(opt.spec, leaves)


def make_steps(G, D, optG, optD, policy):
    """The two updates; three loss-scaler states (errD_real -> scaler 0,
    errD_fake -> scaler 1, errG -> scaler 2), the loss_id plumbing of
    amp.scale_loss(..., loss_id=i)."""
    dynamic = policy.loss_scale == "dynamic"

    def scaled_grads(loss, s, leaves, opt):
        g = torch.autograd.grad(scaler_lib.scale_loss(s, loss), leaves)
        return scaler_lib.unscale(s, FL.tree_from_leaves(opt.spec, list(g)))

    def d_step(d_state, g_state, real, z, s_real, s_fake):
        with torch.no_grad():
            fake = G(_params(optG, g_state, False)[1], z, policy)
        leaves, dp = _params(optD, d_state, True)
        lr_ = bce_with_logits(D(dp, real, policy), 1.0)
        g_r, found_r = scaled_grads(lr_, s_real, leaves, optD)
        lf_ = bce_with_logits(D(dp, fake, policy), 0.0)
        g_f, found_f = scaled_grads(lf_, s_fake, leaves, optD)
        grads = {k: _add(g_r[k], g_f[k]) for k in g_r}
        found = found_r | found_f
        s_real = scaler_lib.update(s_real, found_r, dynamic=dynamic)
        s_fake = scaler_lib.update(s_fake, found_f, dynamic=dynamic)
        _, d_state = optD.step(d_state, grads, found_inf=found)
        return d_state, s_real, s_fake, (lr_ + lf_).detach()

    def g_step(g_state, d_state, z, s_g):
        leaves, gp = _params(optG, g_state, True)
        dp = _params(optD, d_state, False)[1]
        lg_ = bce_with_logits(D(dp, G(gp, z, policy), policy), 1.0)
        grads, found = scaled_grads(lg_, s_g, leaves, optG)
        s_g = scaler_lib.update(s_g, found, dynamic=dynamic)
        _, g_state = optG.step(g_state, grads, found_inf=found)
        return g_state, s_g, lg_.detach()

    return d_step, g_step


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def main(argv=None):
    """Returns {"loss_d": [...], "loss_g": [...], "img_per_s": x} (the
    JAX example's whole-run rate), the first iteration's seconds and the
    rate of the iterations after it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--nz", type=int, default=100)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--beta1", type=float, default=0.5)
    ap.add_argument("--opt-level", default="O1")
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    G = Generator(args.image_size, args.nz)
    D = Discriminator(args.image_size)
    init = torch.Generator().manual_seed(0)
    nets = {"G": G.init(init, dev), "D": D.init(init, dev)}
    # ≡ amp.initialize([netD, netG], [optD, optG], num_losses=3): under
    # O2/O3 this casts both nets' params (BN kept fp32 under O2)
    nets, amp_state = amp.initialize(nets, opt_level=args.opt_level,
                                     num_losses=3, device=dev)
    policy = amp_state.policy
    s_real, s_fake, s_g = amp_state.loss_scalers
    optG = FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    optD = FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    g_state, d_state = optG.init(nets["G"]), optD.init(nets["D"])
    del nets
    d_step, g_step = make_steps(G, D, optG, optD, policy)

    data = torch.Generator(device=dev).manual_seed(1)
    size = (args.batch_size, 3, args.image_size, args.image_size)
    loss_d, loss_g = [], []
    t0 = time.time()
    for it in range(args.iters):
        real = torch.rand(size, generator=data, device=dev) * 2 - 1
        z1 = torch.randn((args.batch_size, args.nz, 1, 1), generator=data,
                         device=dev)
        z2 = torch.randn((args.batch_size, args.nz, 1, 1), generator=data,
                         device=dev)
        d_state, s_real, s_fake, errD = d_step(d_state, g_state, real, z1,
                                               s_real, s_fake)
        g_state, s_g, errG = g_step(g_state, d_state, z2, s_g)
        loss_d.append(errD)
        loss_g.append(errG)
        if it % 10 == 0 or it == args.iters - 1:
            print(f"[{it}/{args.iters}] Loss_D {float(errD):.4f} "
                  f"Loss_G {float(errG):.4f} "
                  f"scale {float(s_g.scale):.0f}")
        if it == 0:
            # the print read the losses back, so the first iteration,
            # with the process's first-use costs (cuDNN's handles and
            # kernels, the optimizer kernel's compile), has ended
            t1 = time.time()
    t_end = time.time()
    dt = t_end - t0
    print(f"{args.iters} iters in {dt:.1f}s "
          f"({args.iters * args.batch_size / dt:.0f} img/s)")
    res = {"loss_d": [float(x) for x in loss_d],
           "loss_g": [float(x) for x in loss_g],
           "img_per_s": args.iters * args.batch_size / dt,
           "first_iter_s": t1 - t0, "img_per_s_after_first": None}
    if args.iters > 1:
        res["img_per_s_after_first"] = ((args.iters - 1) * args.batch_size
                                        / (t_end - t1))
        print(f"after the first: {args.iters - 1} iters in "
              f"{t_end - t1:.1f}s "
              f"({res['img_per_s_after_first']:.0f} img/s)")
    return res


if __name__ == "__main__":
    main()
