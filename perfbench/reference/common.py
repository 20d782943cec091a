"""Pieces the plain references share: precision, the LSTM cell, Adam, the
synthetic envs' frames and rewards.

Plain PyTorch in float32, written from the papers and the configurations'
stated knobs; nothing here comes from the program.

``Precision`` rounds a part's operands and results to the type it is
computed in. The reference rounds nothing (float32, with TF32 off). Its
control computes each part in the nearest type below the one the
configuration states: torsos stated in bfloat16 in float8 (e4m3, scaled
per tensor), parts stated in float32 (the port's matmuls run with TF32
off) in TF32, each emulated by rounding the operands and the result in the
forward and the gradients in the backward.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with a per-tensor scale that maps the largest magnitude to
    e4m3's largest (448), as float8 training scales its tensors."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Rounding(torch.autograd.Function):
    """Rounds the value in the forward and its gradient in the backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def rounding(fn):
    return lambda x: _Rounding.apply(x, fn)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDING = {"float32": exact, "tf32": rounding(_tf32),
            "bfloat16": rounding(_bf16), "float8": rounding(_fp8)}
# The control's type for each stated type.
BELOW = {"bfloat16": "float8", "float32": "tf32"}


class Precision:
    """``torso`` rounds the conv torso's operands, ``core`` the LSTM's,
    ``heads`` the output heads'."""

    def __init__(self, torso: str = "float32", core: str = "float32",
                 heads: str = "float32"):
        self.torso = ROUNDING[torso]
        self.core = ROUNDING[core]
        self.heads = ROUNDING[heads]

    @classmethod
    def control(cls, config) -> "Precision":
        dtypes = config["compute_dtypes"]
        return cls(*(BELOW[dtypes[part]] for part in ("torso", "core",
                                                       "heads")))


def linear(x, weight, bias, q=exact):
    return q(F.linear(q(x), q(weight), None if bias is None else q(bias)))


def conv(x, weight, bias, q=exact, stride=1, padding=0):
    return q(F.conv2d(q(x), q(weight), q(bias), stride, padding))


def lstm_step(p: Dict[str, torch.Tensor], prefix: str, x, carry, done,
              q=exact):
    """One LSTM step (gates i, f, g, o; ``c' = σ(f) c + σ(i) tanh(g)``,
    ``h' = σ(o) tanh(c')``, no forget bias), the carry first reset to zero
    where ``done`` is set. The carry stays float32."""
    c, h = carry
    keep = (~done).to(torch.float32)[:, None]
    c, h = c * keep, h * keep
    gates = (linear(h, p[prefix + "weight_hh"], p[prefix + "bias"], q)
             + linear(x, p[prefix + "weight_ih"], None, q))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (c, h), h


class Adam:
    """Clip by global norm (no epsilon), then Adam with bias correction,
    epsilon outside the square root."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 clip: float):
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        clipped = {n: g * scale for n, g in grads.items()}
        self.t += 1
        for n, g in clipped.items():
            m = self.m.get(n, torch.zeros_like(g))
            v = self.v.get(n, torch.zeros_like(g))
            self.m[n] = m = self.b1 * m + (1 - self.b1) * g
            self.v[n] = v = self.b2 * v + (1 - self.b2) * g * g
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            params[n] -= self.lr * m_hat / (v_hat.sqrt() + self.eps)
        return clipped


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def take_grads(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradients accumulated on ``params`` (zeros where the loss did
    not reach), which are cleared."""
    out = {}
    for n, p in params.items():
        out[n] = torch.zeros_like(p) if p.grad is None else p.grad.detach()
        p.grad = None
    return out


# The synthetic envs' byte pattern (``seed_rl_torch/envs/synthetic.py``'s
# documented formula): the frame at episode step t is
# ``(row + stride * channel + t + seed) % 255``, broadcast over the width;
# the reward is 1 for playing action ``seed % num_actions``; an episode ends
# after ``episode_length`` steps and the next starts at t = 0.
CHANNEL_STRIDE = {"SyntheticAtariEnv": 0, "SyntheticDmLabEnv": 37}
ENV_LEAVES = ("observation", "reward", "done", "episode_step", "abandoned")


def synthetic_env(env, unrolls, overlap: int, device):
    """The env outputs of ``unrolls`` (time-major ``[overlap + T + 1, B]``
    records, unroll k at global steps ``k*T .. k*T + overlap + T``, the
    first starting at the envs' reset) worked out again from the formula.

    Only the actions and each episode's hidden seed are read from the run:
    both are the program's draws. A seed is read where its episode starts
    (at the reset, and where the formula ends an episode), from the
    frame's first byte, which is the seed at t = 0. Returns the records
    with ``ENV_LEAVES`` replaced by the formula's, and the count of the
    run's elements that differ from them.
    """
    stride = CHANNEL_STRIDE[env["class"]]
    actions, length = env["num_actions"], env["episode_length"]
    steps = unrolls[0]["reward"].shape[0]
    t_len = steps - overlap - 1
    total = (len(unrolls) - 1) * t_len + steps
    batch = unrolls[0]["reward"].shape[1]
    first_byte = torch.empty((total, batch), dtype=torch.int64)
    prev_action = torch.empty((total, batch), dtype=torch.int64)
    for k, u in enumerate(unrolls):
        g = k * t_len
        first_byte[g:g + steps] = u["observation"][:, :, 0, 0, 0].long()
        prev_action[g:g + steps] = u["prev_action"].long()
    # Step by step: the episode step, its seed, and what the step emits.
    t = torch.zeros(batch, dtype=torch.int64)
    seed = first_byte[0].clone()
    offset = torch.empty((total, batch), dtype=torch.int64)
    reward = torch.zeros((total, batch), dtype=torch.float32)
    done = torch.zeros((total, batch), dtype=torch.bool)
    episode_step = torch.zeros((total, batch), dtype=torch.int32)
    offset[0] = seed
    for g in range(1, total):
        t = t + 1
        reward[g] = (prev_action[g] == seed % actions).to(torch.float32)
        done[g] = t >= length
        episode_step[g] = t.to(torch.int32)
        seed = torch.where(done[g], first_byte[g], seed)
        t = torch.where(done[g], torch.zeros_like(t), t)
        offset[g] = t + seed

    out, mismatched = [], 0
    for k, u in enumerate(unrolls):
        g = k * t_len
        h, w, c = u["observation"].shape[2:]
        pattern = (torch.arange(h, device=device)[:, None]
                   + stride * torch.arange(c, device=device))  # [H, C]
        off = offset[g:g + steps].to(device)[:, :, None, None]
        frames = ((pattern + off) % 255).to(torch.uint8)[:, :, :, None, :]
        mine = {"observation": frames.expand(-1, -1, -1, w, -1),
                "reward": reward[g:g + steps], "done": done[g:g + steps],
                "episode_step": episode_step[g:g + steps],
                "abandoned": torch.zeros((steps, batch), dtype=torch.bool)}
        record = dict(u)
        for leaf in ENV_LEAVES:
            if leaf in u:
                ours = mine[leaf].to(device, u[leaf].dtype)
                mismatched += int((u[leaf].to(device) != ours).sum())
                record[leaf] = ours.contiguous().cpu()
        out.append(record)
    return out, mismatched
