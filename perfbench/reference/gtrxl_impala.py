"""Plain reference of V-trace on GTrXL over IMPALA's torso (the
``gtrxl_dmlab`` config).

Written from GTrXL (Parisotto et al. 2020, arXiv:1910.06764) and
Transformer-XL (Dai et al. 2019, arXiv:1901.02860): IMPALA's ResNet torso
(``vtrace_impala.torso``), a linear projection of [torso, reward clipped to
±1, one-hot previous action] to the model width, the gated layers, and
IMPALA's policy and baseline heads. Layer l, E its input and M the memory
of earlier inputs:

- ``Ȳ = RelMHA(LayerNorm([sg(M), E]))``: keys, values and queries
  projected from the layer-normed rows, the score
  ``((q_i + u)·k_j + (q_i + v)·W_kR R_{i-j}) / sqrt(head_size)`` with R
  Transformer-XL's sinusoids of the distance, the heads' weighted values
  projected back;
- ``Y = g(E, ReLU(Ȳ))``, ``E' = g(Y, ReLU(MLP(LayerNorm(Y))))``, g the
  GRU-type gate ``(1 - z) x + z tanh(W_g y + U_g (r x))`` with
  ``r = σ(W_r y + U_r x)``, ``z = σ(W_z y + U_z x - b_g)``.

Query t attends to the steps s with ``t - memory_length <= s <= t`` in its
own episode (``s`` at or after the last ``done`` at or before t). The
history is computed in blocks of queries over the rows before them, never
step by step; envs in chunks, so the reference fits beside what the card
still holds. The memory is the rows as they were acted (with the weights
of their step), stored in the core's type, as the program stores them.

``follow`` retraces a run from step 0: the set-up's acting at the drawn
weights (``acting_steps`` env steps, past one episode's end) and the
checked train steps. Of the unrolls it reads as given only the program's
draws: the actions and each episode's hidden seed (the frames' first
byte); the frames, rewards and ``done`` flags it works out again from the
synthetic env's formula (``common.synthetic_env``; the set-up's unrolls
carry one pixel of each frame, the checked ones whole frames). Everything
else it computes: the behaviour outputs, the memory carried into the
checked unrolls, the V-trace targets, each step's loss, the gradients and
Adam's steps (``common.py``). ``compare`` takes either side's readings.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.harness import check
from perfbench.reference import common, vtrace_impala

CHANNEL_STRIDE = common.CHANNEL_STRIDE["SyntheticDmLabEnv"]


def parameter_shapes(config) -> Dict[str, tuple]:
    """The net's parameters by the program's names, in its order."""
    net = config["net"]
    shapes = {n: s for n, s in vtrace_impala.parameter_shapes(
        dict(config, net=dict(net, lstm=1))).items()
        if n.startswith("torso.")}
    d, inner = net["model_size"], net["num_heads"] * net["head_size"]
    heads, size, mlp = net["num_heads"], net["head_size"], net["mlp_size"]
    actions = net["num_actions"]
    shapes["embed.weight"] = (d, net["dense"] + 1 + actions)
    shapes["embed.bias"] = (d,)

    def gate(prefix):
        shapes[prefix + "weight_y"] = (3 * d, d)
        shapes[prefix + "weight_x"] = (2 * d, d)
        shapes[prefix + "weight_rx"] = (d, d)
        shapes[prefix + "bias"] = (d,)

    for i in range(net["num_layers"]):
        s = f"layers.{i}."
        for name in ("query", "key", "value", "position"):
            shapes[s + name] = (inner, d)
        shapes[s + "content_bias"] = shapes[s + "position_bias"] = (heads,
                                                                    size)
        shapes[s + "out"] = (d, inner)
        shapes[s + "norm1.weight"] = shapes[s + "norm1.bias"] = (d,)
        gate(s + "gate1.")
        shapes[s + "norm2.weight"] = shapes[s + "norm2.bias"] = (d,)
        shapes[s + "mlp1.weight"], shapes[s + "mlp1.bias"] = (mlp, d), (mlp,)
        shapes[s + "mlp2.weight"], shapes[s + "mlp2.bias"] = (d, mlp), (d,)
        gate(s + "gate2.")
    shapes["policy_logits.weight"] = (actions, d)
    shapes["policy_logits.bias"] = (actions,)
    shapes["baseline.weight"] = (1, d)
    shapes["baseline.bias"] = (1,)
    return shapes


def starting_values(config, drawn: Dict[str, torch.Tensor]):
    """The leaves a draw leaves at zero (1-D) that start elsewhere: the
    LayerNorms' gains at 1, the gates' b_g at the configuration's."""
    for name, value in drawn.items():
        if name.endswith(("norm1.weight", "norm2.weight")):
            value.fill_(1.0)
        elif name.endswith(("gate1.bias", "gate2.bias")):
            value.fill_(config["net"]["gate_bias"])
    return drawn


def sinusoids(distances, width):
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, width, 2, dtype=torch.float32, device=distances.device) / width))
    angles = distances.to(torch.float32)[..., None] * inv_freq
    return torch.cat([angles.sin(), angles.cos()], dim=-1)


def layer_norm(p, prefix, x):
    return F.layer_norm(x, x.shape[-1:], p[prefix + "weight"],
                        p[prefix + "bias"], 1e-5)


def gate(p, prefix, x, y, q):
    w_r, w_z, w_g = common.linear(y, p[prefix + "weight_y"], None,
                                  q).chunk(3, -1)
    u_r, u_z = common.linear(x, p[prefix + "weight_x"], None, q).chunk(2, -1)
    r = torch.sigmoid(w_r + u_r)
    z = torch.sigmoid(w_z + u_z - p[prefix + "bias"])
    h = torch.tanh(w_g + common.linear(r * x, p[prefix + "weight_rx"], None,
                                       q))
    return (1 - z) * x + z * h


class Net:
    """GTrXL on ImpalaDeep's torso over a dict of parameters at a
    precision."""

    def __init__(self, config, precision: common.Precision, block: int):
        net = config["net"]
        self.num_stacks = len(net["stacks"])
        self.num_actions = net["num_actions"]
        self.num_layers = net["num_layers"]
        self.heads = net["num_heads"]
        self.memory_length = net["memory_length"]
        self.width = net["model_size"]
        self.torso_width = net["dense"]
        self.q = precision
        self.block = block

    def features(self, p, frames):
        """The torso over [N, ...] frames, in blocks, without gradients."""
        with torch.no_grad():
            return torch.cat([
                vtrace_impala.torso(p, frames[i:i + self.block], self.q.torso,
                                    self.num_stacks)
                for i in range(0, frames.shape[0], self.block)])

    def torso_backward(self, p, frames, grad):
        for i in range(0, frames.shape[0], self.block):
            out = vtrace_impala.torso(p, frames[i:i + self.block],
                                      self.q.torso, self.num_stacks)
            out.backward(grad[i:i + self.block])

    def embed(self, p, features, reward, prev_action):
        x = torch.cat([features, reward.clamp(-1.0, 1.0)[..., None],
                       F.one_hot(prev_action.long(), self.num_actions)
                       .to(torch.float32)], dim=-1)
        return common.linear(x, p["embed.weight"], p["embed.bias"],
                             self.q.core)

    def layer(self, p, s, e, rows, distance, mask):
        """Layer ``s`` for the queries ``e`` [B, Q, d] over the stored rows
        before them ``rows`` [B, K - Q, d] and their own; ``distance`` and
        ``mask`` [B or 1, Q, K]."""
        q = self.q.core
        keys = torch.cat([rows, q(e)], dim=1)
        h = q(layer_norm(p, s + "norm1.", keys))
        batch, length, _ = keys.shape
        queries = e.shape[1]
        k = common.linear(h, p[s + "key"], None, q).view(
            batch, length, self.heads, -1)
        v = common.linear(h, p[s + "value"], None, q).view(
            batch, length, self.heads, -1)
        query = common.linear(h[:, -queries:], p[s + "query"], None, q).view(
            batch, queries, self.heads, -1)
        table = common.linear(
            sinusoids(torch.arange(self.memory_length + 1,
                                   device=e.device), self.width),
            p[s + "position"], None, q).view(self.memory_length + 1,
                                             self.heads, -1)
        r = table[distance[0]]  # [Q, K, heads, size]
        content = q(torch.einsum("bqhe,bkhe->bhqk",
                                 q(query + p[s + "content_bias"]), k))
        position = q(torch.einsum("bqhe,qkhe->bhqk",
                                  q(query + p[s + "position_bias"]), r))
        scores = (content + position) / math.sqrt(query.shape[-1])
        probs = q(torch.softmax(scores.masked_fill(~mask[:, None],
                                                   float("-inf")), -1))
        o = q(torch.einsum("bhqk,bkhe->bqhe", probs, v)).reshape(
            batch, queries, -1)
        y = gate(p, s + "gate1.", e,
                 torch.relu(common.linear(o, p[s + "out"], None, q)), q)
        m = torch.relu(common.linear(q(layer_norm(p, s + "norm2.", y)),
                                     p[s + "mlp1.weight"], p[s + "mlp1.bias"],
                                     q))
        m = common.linear(m, p[s + "mlp2.weight"], p[s + "mlp2.bias"], q)
        return gate(p, s + "gate2.", y, torch.relu(m), q)

    def core(self, p, e, memory, first, start, stored=None):
        """The layers for queries ``e`` [B, Q, d] at steps ``first ..
        first + Q - 1`` over ``memory`` (per layer [B, N, d], the rows of
        steps 0..N-1 as stored); ``start`` [B, Q] each query's episode
        start. With ``stored``, each layer's rows of the queries' steps are
        written there (acting). Returns the heads' logits and baselines."""
        queries = e.shape[1]
        device = e.device
        low = max(first - self.memory_length, 0)
        steps = torch.arange(first, first + queries, device=device)
        key_steps = torch.arange(low, first + queries, device=device)
        distance = steps[:, None] - key_steps[None]
        mask = ((distance >= 0) & (distance <= self.memory_length))[None] & (
            key_steps[None, None] >= start[:, :, None])
        distance = distance.clamp(0, self.memory_length)[None]
        for i in range(self.num_layers):
            if stored is not None:
                stored[i][:, first:first + queries] = self.q.core(e).detach()
            e = self.layer(p, f"layers.{i}.", e,
                           memory[i][:, low:first].detach(), distance, mask)
        logits = common.linear(e, p["policy_logits.weight"],
                               p["policy_logits.bias"], self.q.heads)
        baseline = common.linear(e, p["baseline.weight"], p["baseline.bias"],
                                 self.q.heads).squeeze(-1)
        return logits, baseline


def frames_of(first_byte, shape):
    """The synthetic DmLab frames whose first byte (row 0, column 0,
    channel 0: the offset mod 255) is ``first_byte`` [N]: the formula
    ``(row + 37 * channel + offset) % 255``."""
    h, w, c = shape
    pattern = (torch.arange(h, device=first_byte.device)[:, None]
               + CHANNEL_STRIDE * torch.arange(c, device=first_byte.device))
    frames = (pattern + first_byte[:, None, None]) % 255
    return frames[:, :, None, :].expand(-1, -1, w, -1).to(torch.uint8)


def episode_starts(done):
    """[N, B] ``done`` -> the step each step's episode began."""
    steps = torch.arange(done.shape[0], device=done.device)[:, None]
    return torch.where(done, steps, 0).cummax(0).values


def follow(config, traffic, inputs, precision, device, block: int = 1024,
           envs: int = 128, queries: int = 128):
    """The reference's readings over the set-up's acting and the checked
    train steps of ``inputs`` (``builders/gtrxl_vtrace.py``), from the
    weights ``inputs["theta0"]``: ``envs`` envs and ``queries`` steps a
    block."""
    t_len = traffic["unroll_length"]
    records, env_mismatched = common.synthetic_env(
        config["env"], inputs["setup"] + inputs["unrolls"], 0, device)
    first_byte = torch.cat([records[0]["observation"][:, :, 0, 0, 0]] + [
        r["observation"][1:, :, 0, 0, 0] for r in records[1:]]).to(device)
    history = {key: torch.cat([records[0][key]] + [r[key][1:]
                                                   for r in records[1:]])
               .to(device) for key in ("reward", "done", "prev_action")}
    total, batch = first_byte.shape
    frame_shape = tuple(config["net"]["frame_shape"])
    start = episode_starts(history["done"]).T  # [B, N]
    knobs = config["learner"]
    net = Net(config, precision, block)
    params = {n: t.to(device, torch.float32).clone().requires_grad_(True)
              for n, t in inputs["theta0"].items()}
    adam = common.Adam(knobs["learning_rate"], knobs["adam_b1"], 0.999,
                       knobs["adam_epsilon"], knobs["clip_norm"])
    weights = [{n: t.detach().clone() for n, t in params.items()}]
    width = config["net"]["model_size"]
    memory = [torch.zeros((batch, total, width), device=device)
              for _ in range(net.num_layers)]
    logits = torch.zeros((total, batch, net.num_actions), device=device)
    baseline = torch.zeros((total, batch), device=device)

    def features(p, steps):
        frames = frames_of(first_byte[steps].flatten(), frame_shape)
        return net.features(p, frames).view(-1, batch, net.torso_width)

    def act(p, begin, end):
        """Steps ``begin .. end - 1``, acted with ``p``, in blocks."""
        with torch.no_grad():
            for first in range(begin, end, queries):
                steps = slice(first, min(first + queries, end))
                feats = features(p, steps)
                for b in range(0, batch, envs):
                    cols = slice(b, b + envs)
                    e = net.embed(p, feats[:, cols],
                                  history["reward"][steps, cols],
                                  history["prev_action"][steps, cols])
                    out = net.core(p, e.transpose(0, 1),
                                   [m[cols] for m in memory], first,
                                   start[cols, steps],
                                   [m[cols] for m in memory])
                    logits[steps, cols] = out[0].transpose(0, 1)
                    baseline[steps, cols] = out[1].T

    readings = {"env": env_mismatched, "logits": [], "baseline": [],
                "memory": [], "vtrace": [], "loss": []}
    acting = inputs["acting_steps"]
    act(weights[0], 0, acting + 1)
    gamma = knobs["discounting"]
    for k in range(len(inputs["unrolls"])):
        first = acting + k * t_len  # the unroll's first step
        steps = slice(first, first + t_len + 1)
        # The T steps after the boundary were acted with the weights now.
        act(weights[k], first + 1, first + t_len + 1)
        readings["logits"].append(logits[steps].clone())
        readings["baseline"].append(baseline[steps].clone())
        if k < 2:
            readings["memory"].append(memory_rows(memory, first, start,
                                                  net.memory_length))
        # The update, from the memory as the unroll stores it.
        with torch.no_grad():
            frames = frames_of(first_byte[steps].flatten(), frame_shape)
            feats = net.features(params, frames).view(t_len + 1, batch, -1)
        feats.requires_grad_(True)
        loss_sum, vs_parts, adv_parts = 0.0, [], []
        count = t_len * batch
        for b in range(0, batch, envs):
            cols = slice(b, b + envs)
            e = net.embed(params, feats[:, cols],
                          history["reward"][steps, cols],
                          history["prev_action"][steps, cols])
            out_logits, out_base = net.core(
                params, e.transpose(0, 1), [m[cols] for m in memory], first,
                start[cols, steps])
            out_logits, out_base = out_logits.transpose(0, 1), out_base.T
            actions = inputs["unrolls"][k]["action"][:-1, cols].to(
                device).long()[..., None]
            logp = F.log_softmax(out_logits[:-1], -1)
            target_logp = logp.gather(-1, actions).squeeze(-1)
            behaviour_logp = F.log_softmax(
                logits[steps][:-1, cols], -1).gather(-1, actions).squeeze(-1)
            discounts = (~history["done"][steps][1:, cols]).to(
                torch.float32) * gamma
            values = out_base[:-1]
            with torch.no_grad():
                vs, pg_adv = vtrace_impala.vtrace(
                    target_logp - behaviour_logp, discounts,
                    history["reward"][steps][1:, cols], values, out_base[-1])
            vs_parts.append(vs)
            adv_parts.append(pg_adv)
            policy = -torch.sum(target_logp * pg_adv) / count
            value = knobs["baseline_cost"] * 0.5 * torch.sum(
                torch.square(vs - values)) / count
            entropy = torch.sum(-torch.sum(logp.exp() * logp, -1)) / count
            loss = policy + value - knobs["entropy_cost"] * entropy
            loss.backward()
            loss_sum += float(loss.detach())
        readings["vtrace"].append((torch.cat(vs_parts, 1),
                                   torch.cat(adv_parts, 1)))
        readings["loss"].append(loss_sum)
        net.torso_backward(params, frames, feats.grad.flatten(0, 1))
        clipped = adam.step(params, common.take_grads(params))
        weights.append({n: t.detach().clone() for n, t in params.items()})
        if k == 0:
            readings["grad_norms"] = common.norms(clipped)
    readings["change_norms"] = common.norms(
        {n: weights[-1][n] - weights[0][n] for n in params})
    # No loss term reaches the entropy cost's parameter (no target
    # entropy), so Adam leaves it where it is.
    readings["grad_norms"]["entropy_cost"] = 0.0
    readings["change_norms"]["entropy_cost"] = 0.0
    return readings


def memory_rows(memory, first, start, memory_length):
    """The rows a state holds at step ``first`` (at least the ring's
    length) that a query of its episode can still see: the steps from
    ``first - memory_length`` and from the episode's start (as of step
    ``first - 1``) to ``first - 1``: ``first``, the mask over the ring's
    steps ``first - memory_length - 1 .. first - 1`` in time order
    (``valid``) and each layer's rows there (``rows``), on the CPU."""
    ring = memory_length + 1
    steps = torch.arange(first - ring, first, device=start.device)
    valid = (steps >= first - memory_length)[None] & (
        steps[None] >= start[:, first - 1:first])
    return {"first": first, "valid": valid.cpu(),
            "rows": [m[:, first - ring:first][valid].cpu() for m in memory]}


def compare(program, reference) -> Dict[str, float]:
    """The gaps of ``program``'s readings from ``reference``'s.

    ``env`` counts the run's env outputs unlike the formula's.
    ``rollout``: the first checked unroll's behaviour logits and
    baselines, acted with the drawn weights. ``memory``: the rows the
    first two checked unrolls store that a query can see (the ring's slot
    ``step % (memory_length + 1)``), the worst layer's gap. ``vtrace`` and
    ``loss_first``: the first step's targets and loss; ``loss`` each
    step's; ``grad`` the first gradient's leaves; ``change`` the weights
    after the last step, as ``vtrace_impala.compare`` reads them."""
    gaps = []
    for want, got in zip(reference["memory"], program["memory"]):
        rows = got.get("rows")
        if rows is None:  # the program's rings: slot step % ring holds step
            ring = want["valid"].shape[1]
            order = (want["first"] + torch.arange(ring)) % ring
            rows = [r[:, order][want["valid"]] for r in got["rings"]]
        gaps += [check.tensor_gap(p, r) for p, r in zip(rows, want["rows"])]
    numbers = vtrace_impala.compare(
        dict(program, core=[]), dict(reference, core=[]))
    numbers["memory"] = max(gaps)
    return numbers
