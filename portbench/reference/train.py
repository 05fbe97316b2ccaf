"""The reference's training steps: the pixel loss against its own render of
the target, its gradient by autograd, and Adam written out.

`adam_steps` runs the reference's own trajectory (the control, the planted
half-batch fault, the look at independent trajectories). `follow` judges
the program's first steps: the reference's loss and gradient at each state
that the program's steps started from, and Adam over the gradients that the
program's optimizer got."""

import torch

from portbench.reference.whitted import Reference


class Adam:
    """Adam written out (torch.optim.Adam's defaults, no weight decay)."""

    def __init__(self, p0: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.p = {k: v.detach().clone() for k, v in p0.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0

    def step(self, g: dict) -> None:
        b1, b2 = self.betas
        self.t += 1
        for k in self.p:
            gk = g[k].to(self.p[k])
            self.m[k] = b1 * self.m[k] + (1 - b1) * gk
            self.v[k] = b2 * self.v[k] + (1 - b2) * gk * gk
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            self.p[k] = self.p[k] - self.lr * mh / (vh.sqrt() + self.eps)


def adam_steps(ref: Reference, view: dict, p0: dict, target, steps: int, lr: float,
               half_rows: bool = False) -> dict:
    """`steps` Adam steps of the reference from the parameters `p0` ({name:
    tensor}) → {"losses", "grads", "states": each step's loss, gradient and
    the parameters it was taken at; "change": the parameters after the
    steps less `p0`}. `half_rows` takes the loss over the top half of the
    frame only, its mean over those rows (a planted fault)."""
    opt = Adam(p0, lr)
    out = {"losses": [], "grads": [], "states": []}
    for _ in range(steps):
        out["states"].append({k: v.clone() for k, v in opt.p.items()})
        loss, g = ref.loss_and_grad(view, opt.p, target,
                                    ref.height // 2 if half_rows else None)
        out["losses"].append(loss)
        out["grads"].append({k: x.detach().clone() for k, x in g.items()})
        opt.step(g)
    out["change"] = {k: opt.p[k] - out["states"][0][k] for k in opt.p}
    return out


def follow(ref: Reference, view: dict, target, p0: dict, later: list, grads: list,
           lr: float) -> dict:
    """The reference along the program's trajectory: its loss and gradient
    at its own start `p0` and at each of `later` (the parameters that the
    program's later steps started from), and the change that Adam makes of
    `p0` with the program's gradients `grads`."""
    start = {k: v.double() for k, v in p0.items()}
    opt = Adam(start, lr)
    out = {"losses": [], "grads": []}
    for p, g in zip([p0] + list(later), grads):
        loss, gr = ref.loss_and_grad(view, {k: v.to(ref.device, ref.dtype)
                                            for k, v in p.items()}, target)
        out["losses"].append(loss)
        out["grads"].append({k: x.detach().clone() for k, x in gr.items()})
        opt.step(g)
    out["change"] = {k: opt.p[k] - start[k] for k in start}
    return out
