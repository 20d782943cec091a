"""A plain float64 reference of GTrXL on IMPALA's ResNet torso, for the CPU
tests of ``seed_rl_torch.models.gtrxl``.

Written from the papers (Parisotto et al. 2020, arXiv:1910.06764;
Transformer-XL, Dai et al. 2019, arXiv:1901.02860; IMPALA, arXiv:1802.01561)
in plain ``torch`` on a dict of parameters named as the port's net names
them. It imports nothing of the port and no JAX. It is the mathematics of
``perfbench/reference/gtrxl_impala.py``, the benchmark's copy, in its
textbook form: keys and values projected from every row, the score
``(q_i + u)·k_j + (q_i + v)·W_kR R_{i-j}``, and the whole history in one
masked pass a layer: query t attends to the steps ``s`` with
``max(t - memory_length, start(t)) <= s <= t``, where ``start(t)`` is the
step its episode began (the last ``done`` at or before t, else 0).
"""

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

F64 = torch.float64


def max_pool_same(x):
    """3x3 max pool at stride 2 with TF's SAME padding (the extra row or
    column at the high end), padding with -inf."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def torso(p, frames):
    """uint8 [N, H, W, C] frames -> [N, 256]: 3 residual stacks, ReLU,
    Dense, ReLU."""
    x = frames.permute(0, 3, 1, 2).to(F64) / 255.0
    i = 0
    while f"torso.stacks.{i}.conv.weight" in p:
        s = f"torso.stacks.{i}."
        x = max_pool_same(F.conv2d(x, p[s + "conv.weight"],
                                   p[s + "conv.bias"], padding=1))
        j = 0
        while f"{s}blocks.{j}.0.weight" in p:
            b = f"{s}blocks.{j}."
            y = F.conv2d(torch.relu(x), p[b + "0.weight"], p[b + "0.bias"],
                         padding=1)
            x = x + F.conv2d(torch.relu(y), p[b + "1.weight"],
                             p[b + "1.bias"], padding=1)
            j += 1
        i += 1
    x = torch.relu(x).permute(0, 2, 3, 1).flatten(1)
    return torch.relu(F.linear(x, p["torso.dense.weight"],
                               p["torso.dense.bias"]))


def sinusoids(distances, width):
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, width, 2, dtype=F64)
                                  / width))
    angles = distances.to(F64)[:, None] * inv_freq
    return torch.cat([angles.sin(), angles.cos()], dim=-1)


def gate(p, prefix, x, y):
    """The GRU-type gate g(x, y)."""
    w_r, w_z, w_g = p[prefix + "weight_y"].chunk(3)
    u_r, u_z = p[prefix + "weight_x"].chunk(2)
    r = torch.sigmoid(y @ w_r.T + x @ u_r.T)
    z = torch.sigmoid(y @ w_z.T + x @ u_z.T - p[prefix + "bias"])
    h = torch.tanh(y @ w_g.T + (r * x) @ p[prefix + "weight_rx"].T)
    return (1 - z) * x + z * h


def layer_norm(p, prefix, x):
    return F.layer_norm(x, x.shape[-1:], p[prefix + "weight"],
                        p[prefix + "bias"], 1e-5)


def starts(done):
    """[N, B] bool -> the step each step's episode began, [N, B]."""
    steps = torch.arange(done.shape[0])[:, None].expand_as(done)
    return torch.where(done, steps, 0).cummax(0).values


def core(p, x, done, num_heads: int, memory_length: int,
         grad_from: int = 0):
    """The core over a whole history: x [N, B, in] from step 0 (the first
    acting step), ``done`` [N, B]. Rows of steps before ``grad_from`` enter
    as keys stop-gradient, as memory does. Returns the last layer's output
    [N, B, d] and every layer's input [L][N, B, d]."""
    e = (x @ p["embed.weight"].T + p["embed.bias"]).transpose(0, 1)
    steps = x.shape[0]
    t = torch.arange(steps)
    distance = t[:, None] - t[None, :]  # query, key
    start = starts(done).T  # [B, N]
    mask = ((distance >= 0) & (distance <= memory_length))[None] & (
        t[None, None, :] >= start[:, :, None])
    width = e.shape[-1]
    rel = sinusoids(distance.clamp(0, memory_length).flatten(),
                    width).view(steps, steps, width)
    inputs = []
    i = 0
    while f"layers.{i}.query" in p:
        s = f"layers.{i}."
        inputs.append(e.transpose(0, 1))
        keys = torch.cat([e[:, :grad_from].detach(), e[:, grad_from:]], 1)
        h = layer_norm(p, s + "norm1.", keys)
        batch = e.shape[0]
        q = (h @ p[s + "query"].T).view(batch, steps, num_heads, -1)
        k = (h @ p[s + "key"].T).view(batch, steps, num_heads, -1)
        v = (h @ p[s + "value"].T).view(batch, steps, num_heads, -1)
        r = (rel @ p[s + "position"].T).view(steps, steps, num_heads, -1)
        content = torch.einsum("bihe,bjhe->bhij", q + p[s + "content_bias"],
                               k)
        position = torch.einsum("bihe,ijhe->bhij",
                                q + p[s + "position_bias"], r)
        scores = (content + position) / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(~mask[:, None], float("-inf"))
        o = torch.einsum("bhij,bjhe->bihe", scores.softmax(-1), v)
        y = o.reshape(batch, steps, -1) @ p[s + "out"].T
        y = gate(p, s + "gate1.", e, torch.relu(y))
        m = torch.relu(layer_norm(p, s + "norm2.", y) @ p[s + "mlp1.weight"].T
                       + p[s + "mlp1.bias"])
        m = m @ p[s + "mlp2.weight"].T + p[s + "mlp2.bias"]
        e = gate(p, s + "gate2.", y, torch.relu(m))
        i += 1
    return e.transpose(0, 1), inputs


def forward(p: Dict[str, torch.Tensor], frames, reward, prev_action, done,
            num_actions: int, num_heads: int, memory_length: int,
            grad_from: int = 0):
    """The net over a whole history of [N, B] steps from step 0: policy
    logits [N, B, A], baselines [N, B], and every layer's inputs."""
    n, b = reward.shape
    feats = torso(p, frames.flatten(0, 1)).view(n, b, -1)
    x = torch.cat([feats, reward.to(F64).clamp(-1, 1)[..., None],
                   F.one_hot(prev_action.long(), num_actions).to(F64)], -1)
    out, inputs = core(p, x, done, num_heads, memory_length, grad_from)
    logits = out @ p["policy_logits.weight"].T + p["policy_logits.bias"]
    baseline = (out @ p["baseline.weight"].T + p["baseline.bias"])[..., 0]
    return logits, baseline, inputs


def vtrace_loss(logits, baseline, behaviour_logits, actions, rewards, done,
                discounting: float, baseline_cost: float,
                entropy_cost: float):
    """V-trace's loss over one [T + 1, B] unroll (ρ̄ = c̄ = 1, λ = 1), the
    last step bootstrap only: the policy gradient on the V-trace
    advantages, ``baseline_cost * 0.5`` times the squared error to
    ``vs`` and the entropy bonus, each a mean over [T, B]."""
    logp = F.log_softmax(logits[:-1], -1)
    a = actions[:-1].long()[..., None]
    target_logp = logp.gather(-1, a)[..., 0]
    behaviour_logp = F.log_softmax(behaviour_logits[:-1], -1).gather(
        -1, a)[..., 0]
    discounts = (~done[1:]).to(F64) * discounting
    values, bootstrap = baseline[:-1], baseline[-1]
    with torch.no_grad():
        rhos = torch.exp(target_logp - behaviour_logp).clamp(max=1.0)
        next_values = torch.cat([values[1:], bootstrap[None]])
        deltas = rhos * (rewards[1:] + discounts * next_values - values)
        acc, diffs = torch.zeros_like(bootstrap), []
        for t in reversed(range(values.shape[0])):
            acc = deltas[t] + discounts[t] * rhos[t] * acc
            diffs.append(acc)
        vs = torch.stack(diffs[::-1]) + values
        next_vs = torch.cat([vs[1:], bootstrap[None]])
        advantages = rhos * (rewards[1:] + discounts * next_vs - values)
    policy = -torch.mean(target_logp * advantages)
    value = baseline_cost * 0.5 * torch.mean(torch.square(vs - values))
    entropy = torch.mean(-torch.sum(logp.exp() * logp, -1))
    return policy + value - entropy_cost * entropy


def params_of(net) -> Dict[str, torch.Tensor]:
    """The net's parameters in float64, by its names, as leaves that take
    gradients."""
    return {n: t.detach().to(F64).clone().requires_grad_(True)
            for n, t in net.named_parameters()}


def history(unrolls: List[dict], overlap: int = 0):
    """Time-major [T + 1, B] unrolls, consecutive ones sharing their boundary
    step, joined into the [N, B] history from step 0."""
    out = {}
    for key in unrolls[0]:
        parts = [unrolls[0][key]] + [u[key][overlap + 1:]
                                     for u in unrolls[1:]]
        out[key] = torch.cat(parts)
    return out
