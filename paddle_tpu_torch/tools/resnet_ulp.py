#!/usr/bin/env python3
"""How far ResNet-50's f32 training steps move when their input moves by
one ulp: the yardstick behind ``chip_smoke.py``'s 10c / 10d checks.

ResNet-50 from seed 0 (Paddle's initializers), BatchNorm in train mode,
``Momentum(lr, 0.9, weight_decay 1e-4)``, two steps on normal images
from generators seeded 10 and 11. Each run is repeated with every
element of the step's images moved one ulp up, and the relative L2
between the two is printed for the loss, the logits, the gradient, the
parameters after the step and the BN running statistics, with the
step's own move of the parameters. ``free``: both runs go on from
their own first step; ``same state``: the second step of both starts
from the unmoved run's state, which is how the checks compare. Any
difference two f32 implementations of the step show is of this order or
larger. Run from the repository root; the CPU by default::

    python3 paddle_tpu_torch/tools/resnet_ulp.py [--device cpu]
        [--batch 2] [--lr 0.1 --lr 2e-4 ...]
"""
import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.vision.models import resnet50  # noqa: E402


def rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


def flat(tensors):
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])


def step(state, vel, x, y, lr):
    """One step from ``(state, vel)``: its readings, the state and the
    velocity after it."""
    model = resnet50()
    model.set_state_dict(state)
    params = model.parameters()
    logits = model(x)
    loss = pt.nn.CrossEntropyLoss()(logits, y)
    loss.backward()
    grads = [p.grad for p in params]
    opt = pt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                weight_decay=1e-4)
    new, st = opt.update(params, grads, {"velocity": vel})
    with torch.no_grad():
        for p, n in zip(params, new):
            p.copy_(n)
    sd = model.state_dict()
    return (dict(loss=flat([loss.reshape(1)]), logits=flat([logits]),
                 grad=flat(grads), params=flat(new),
                 stats=flat([sd[k] for k in sd
                             if k.endswith(("_mean", "_variance"))])),
            {k: v.detach().clone() for k, v in sd.items()},
            st["velocity"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, action="append")
    args = ap.parse_args(argv)
    dev = pt.set_device(args.device)
    pt.seed(0)
    init = {k: v.detach().clone() for k, v in resnet50().state_dict().items()}
    names = [k for k, _ in resnet50().named_parameters()]
    batches = []
    for seed in (10, 11):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(args.batch, 3, 224, 224, generator=g)
        y = torch.randint(0, 1000, (args.batch,), generator=g)
        batches.append((x.to(dev), y.to(dev)))
    for lr in args.lr or [0.1, 1e-3, 2e-4]:
        zeros = [torch.zeros_like(init[k]) for k in names]
        runs = {}
        for moved in (False, True):
            state, vel, out = init, zeros, []
            for x, y in batches:
                if moved:
                    x = torch.nextafter(x, torch.full_like(x, math.inf))
                r, state, vel = step(state, vel, x, y, lr)
                out.append((r, state, vel))
            runs[moved] = out
        (a1, s1, v1), (a2, _, _) = runs[False]
        b1, b2f = runs[True][0][0], runs[True][1][0]
        x, y = batches[1]
        b2s = step(s1, v1, torch.nextafter(x, torch.full_like(x, math.inf)),
                   y, lr)[0]
        p0 = flat(init[k] for k in names)
        p1 = flat(s1[k] for k in names)
        for what, a, b, before in (("step 1", a1, b1, p0),
                                   ("step 2, free", a2, b2f, p1),
                                   ("step 2, same state", a2, b2s, p1)):
            print("lr %g, batch %d, %s: %s; the step moves the parameters "
                  "by %.3g" % (lr, args.batch, what, ", ".join(
                      "%s %.3g" % (k, rel(b[k], a[k])) for k in a),
                      rel(a["params"], before)), flush=True)


if __name__ == "__main__":
    main()
