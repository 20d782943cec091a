"""Each ImpalaDeep component's backward, timed alone, at the train shape.

The port of ``scripts/exp_bwd_decomp.py``: the forward and the backward
(which runs the forward again, as a vjp does) of the bf16 ImpalaResNetTorso,
of each residual stack at its input shape, of the SAME max pool at each
stack's shape (``ops/pooling.py::max_pool_same``, the port's pool) and of
each 3x3 SAME conv, the conv's backward also split into the input gradient
alone (dx) and the parameter gradient alone (dp), at n = 8448 frames (33 x
256, the DmLab train shape).

Every backward is ``torch.autograd.grad(out, inputs, grad_outputs=<random
cotangent>)``, for the script's reason: a ``.sum()`` loss gives a cotangent
of ones, which a linear op's backward can fold, so its time would be low.
Rows are timed and profiled as ``tools/_timing.py`` says; this path runs no
kernel of the port.

Run:  python -m seed_rl_torch.tools.exp_bwd_decomp [--device=cpu]
          [--n=8448] [--iters=20]
"""

import argparse

import torch
import torch.nn.functional as F

from seed_rl_torch.tools import _timing

BF16 = torch.bfloat16
STACK_SHAPES = ((72, 96, 3, 16), (36, 48, 16, 32), (18, 24, 32, 32))
POOL_SHAPES = ((72, 96, 16), (36, 48, 32), (18, 24, 32))
CONV_SHAPES = ((72, 96, 3, 16, "stack0 downscale"),
               (36, 48, 16, 16, "stack0 res conv"),
               (36, 48, 16, 32, "stack1 downscale"),
               (18, 24, 32, 32, "stack1 res conv"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--n", type=int, default=8448)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


class _Probe:
    def __init__(self, device, iters):
        self.device, self.iters = device, iters
        self.data = _timing.Data(device)
        self.rows = {}

    def randn(self, shape, dtype=BF16):
        return self.data.randn(shape, dtype)

    def timeit(self, name, fn):
        self.rows[name] = _timing.timeit(name, fn, self.device, self.iters,
                                         width=52)
        return self.rows[name]

    def fwd_and_bwd(self, name, f, wrt):
        """Times ``f()``'s forward and its vjp in ``wrt`` with a random
        cotangent; returns the cotangent."""
        with torch.no_grad():
            out = f()
        ct = self.randn(out.shape, out.dtype)
        with torch.no_grad():
            tf = self.timeit(f"{name} fwd", f)
        tb = self.timeit(f"{name} bwd(vjp, rand ct)",
                         lambda: torch.autograd.grad(f(), wrt, ct))
        print(f"  -> bwd-incl-fwd/fwd {tb.ms / tf.ms:5.2f}x; bwd-only est "
              f"{tb.ms - tf.ms:7.2f} ms")
        return ct


def main(argv=None):
    """Returns the rows and the card."""
    from seed_rl_torch.models.core import conv
    from seed_rl_torch.models.resnets import ImpalaResNetTorso, ResidualStack
    from seed_rl_torch.ops.pooling import max_pool_same

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    n = args.n
    gen = torch.Generator().manual_seed(0)  # parameters, on the host
    probe = _Probe(device, args.iters)
    card = _timing.card(device)

    print(f"== full torso (n={n}; {card}) ==")
    frames = probe.data.frames((n, 72, 96, 3))
    torso = ImpalaResNetTorso((72, 96, 3), gen, dtype=BF16).to(device)
    probe.fwd_and_bwd("torso", lambda: torso(frames),
                      list(torso.parameters()))

    print("\n== per-stack ==")
    for i, (h, w, cin, cout) in enumerate(STACK_SHAPES):
        x = probe.randn((n, cin, h, w)).requires_grad_()
        stack = ResidualStack(cin, cout, 2, gen, dtype=BF16).to(device)
        probe.fwd_and_bwd(f"stack{i} {cin}->{cout} @{h}x{w}",
                          lambda stack=stack, x=x: stack(x),
                          list(stack.parameters()) + [x])

    print("\n== max_pool 3x3/2 SAME alone ==")
    for h, w, c in POOL_SHAPES:
        x = probe.randn((n, c, h, w)).requires_grad_()
        probe.fwd_and_bwd(f"pool @{h}x{w}x{c}",
                          lambda x=x: max_pool_same(x), [x])

    print("\n== single 3x3 convs: vjp split into dx / dp ==")
    for h, w, cin, cout, tag in CONV_SHAPES:
        x = probe.randn((n, cin, h, w)).requires_grad_()
        layer = conv(cin, cout, 3, 1, 1, gen).to(device, BF16)
        params = [layer.weight, layer.bias]

        def f(layer=layer, x=x):
            return F.conv2d(x, layer.weight, layer.bias, 1, 1)

        ct = probe.fwd_and_bwd(f"{tag} {cin}->{cout} @{h}x{w}", f,
                               params + [x])
        probe.timeit(f"{tag}  dx only (incl fwd)",
                     lambda f=f, x=x, ct=ct: torch.autograd.grad(f(), [x],
                                                                 ct))
        probe.timeit(f"{tag}  dp only (incl fwd)",
                     lambda f=f, p=params, ct=ct: torch.autograd.grad(
                         f(), p, ct))
    print(card, flush=True)
    return {"rows": probe.rows, "card": card}


if __name__ == "__main__":
    main()
