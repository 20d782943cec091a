"""A/B of ImpalaDeep's SAME max pool: PyTorch's own ``max_pool2d`` with its
implicit padding against the port's ``ops/pooling.py::max_pool_same``.

The port of ``scripts/exp_pool_vjp.py``. The JAX script set flax's
``nn.max_pool`` (XLA's SelectAndScatter backward) against the JAX
package's dense custom backward. Both arms here use PyTorch's
``max_pool2d`` backward, which routes each window's gradient to its first
maximum; they differ in how they get SAME padding:

  - ``library``: ``F.max_pool2d(x, 3, 2, ceil_mode=True)``. The ceiling
    lets the last window hang over the high edge, which is SAME padding
    wherever SAME pads nothing at the low edge (every ImpalaDeep shape:
    72x96, 36x48 and 18x24 pad (0, 1)); other shapes raise.
  - ``port``: ``max_pool_same``, which pads a copy of the input with -inf
    (``F.pad``) and pools it unpadded.

The library pool is here only as this A/B's other arm; the port's path
runs ``max_pool_same``. Three sections, as the script's, each arm timed
and profiled as ``tools/_timing.py`` says:

  1. the pool alone: the input gradient for a random cotangent at each
     stack's shape, n = 8448 (the train shape, 33 x 256), bf16; the two
     arms' outputs and input gradients are compared;
  2. the full ImpalaResNetTorso (bf16) forward and backward in the
     parameters, a random cotangent;
  3. the full DmLab V-trace train step, B = 256, T = 32
     (``seed_rl_torch.bench.dmlab_vtrace_learner``), which launches the
     V-trace kernel at [32, 256] once a step.

Sections 2 and 3 swap the pool the residual stacks call
(``models/resnets.py``) for the arm's while they run.

Run:  python -m seed_rl_torch.tools.exp_pool_vjp [--device=cpu] [--n=8448]
          [--envs=256] [--iters=20]
"""

import argparse
import contextlib

import torch
import torch.nn.functional as F

from seed_rl_torch.ops import pooling
from seed_rl_torch.tools import _timing

SHAPES = ((72, 96, 16), (36, 48, 32), (18, 24, 32))  # (h, w, c) per stack
UNROLL = 32  # the DmLab train step's


def library_pool(x, window=(3, 3), strides=(2, 2)):
    """SAME max pool through ``max_pool2d``'s ceiling mode; the shapes
    whose SAME padding starts at the low edge raise."""
    for size, k, s in zip(x.shape[-2:], window, strides):
        if pooling._same_pads(size, k, s)[0]:
            raise ValueError(f"SAME pads the low edge of size {size}: "
                             "the ceiling mode does not express it")
    return F.max_pool2d(x, window, strides, ceil_mode=True)


POOLS = {"library": library_pool, "port": pooling.max_pool_same}


@contextlib.contextmanager
def residual_stacks_pool(arm):
    """The residual stacks pool with ``arm``'s pool while this is open."""
    from seed_rl_torch.models import resnets

    original = resnets.max_pool_same
    resnets.max_pool_same = POOLS[arm]
    try:
        yield
    finally:
        resnets.max_pool_same = original


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--n", type=int, default=8448)
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def pool_alone(device, n, iters, width=52):
    """Section 1; returns the rows and, per shape, whether the outputs are
    equal and the largest difference of the input gradients."""
    data = _timing.Data(device)
    rows, agreement = {}, {}
    for h, w, c in SHAPES:
        x = data.randn((n, c, h, w), torch.bfloat16).requires_grad_()
        ct = data.randn((n, c, -(-h // 2), -(-w // 2)), torch.bfloat16)
        outs = {}
        for arm, pool in POOLS.items():
            out = pool(x)
            outs[arm] = (out.detach(), torch.autograd.grad(out, x, ct)[0])
            rows[(h, w, c, arm)] = _timing.timeit(
                f"@{h}x{w}x{c} {arm} bwd(vjp, rand ct)",
                lambda pool=pool: torch.autograd.grad(pool(x), x, ct),
                device, iters, width=width)
        speedup = rows[(h, w, c, "library")].ms / rows[(h, w, c, "port")].ms
        (out_l, grad_l), (out_p, grad_p) = outs["library"], outs["port"]
        agreement[(h, w, c)] = {
            "outputs_equal": bool(torch.equal(out_l, out_p)),
            "grad_max_abs_diff": float(
                (grad_l.float() - grad_p.float()).abs().max())}
        print(f"  -> library / port {speedup:5.2f}x; "
              f"{agreement[(h, w, c)]}")
    return rows, agreement


def torso_rows(device, n, iters, width=52):
    """Section 2, one row per arm."""
    from seed_rl_torch.models.resnets import ImpalaResNetTorso

    gen = torch.Generator().manual_seed(0)  # parameters, on the host
    data = _timing.Data(device)
    frames = data.frames((n, 72, 96, 3))
    ct = data.randn((n, 256))
    torso = ImpalaResNetTorso((72, 96, 3), gen,
                              dtype=torch.bfloat16).to(device)
    params = list(torso.parameters())
    rows = {}
    for arm in POOLS:
        with residual_stacks_pool(arm):
            rows[arm] = _timing.timeit(
                f"torso fwd+bwd pool={arm}",
                lambda: torch.autograd.grad(torso(frames), params, ct),
                device, iters, width=width)
    return rows


def train_step_rows(device, envs, unroll, iters, width=52):
    """Section 3, one row per arm."""
    from seed_rl_torch.bench import dmlab_vtrace_learner

    rows = {}
    for arm in POOLS:
        with residual_stacks_pool(arm):
            learner = dmlab_vtrace_learner(device, envs, unroll)
            held = {"state": learner.init()}

            def step():
                held["state"] = learner.train_step(held["state"])[0]

            rows[arm] = _timing.timeit(f"train step pool={arm}", step,
                                       device, iters, envs * unroll, width)
        print(f"  -> {rows[arm].fps / 1e3:7.1f}k env frames/s")
    return rows


def main(argv=None):
    """Returns each section's rows, the agreement and the card."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    card = _timing.card(device)
    print(f"== pool alone: bwd(vjp, rand ct), n={args.n} ({card}) ==")
    pool, agreement = pool_alone(device, args.n, args.iters)
    print("\n== torso fwd+bwd(vjp, rand ct wrt params) ==")
    torso = torso_rows(device, args.n, args.iters)
    print(f"\n== full DmLab V-trace train step (B={args.envs}, "
          f"T={UNROLL}) ==")
    step = train_step_rows(device, args.envs, UNROLL, args.iters)
    print(card, flush=True)
    return {"pool": pool, "agreement": agreement, "torso": torso,
            "train_step": step, "card": card}


if __name__ == "__main__":
    main()
