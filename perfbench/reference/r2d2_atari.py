"""Plain reference of R2D2 on DuelingLSTMDQNNet (the ``r2d2_atari`` config).

Written from R2D2 (Kapturowski et al., ICLR 2019) and the configuration's
knobs: the Nature-DQN torso over the last 4 frames (history zeroed across
an episode's start), an LSTM over [features, reward, one-hot previous
action] that starts from zero where ``done`` is set, dueling heads
``Q = V + A - mean(A)`` (no bias on A); prioritized replay (priorities
``p^α / Σ p^α``, importance weights ``(N P(i))^-β`` over their batch's
largest), burn-in through the online and target nets, the double-DQN
n-step target on h-rescaled values (``h(x) = sign(x)(sqrt(|x|+1)-1) +
εx``), priorities ``η max|δ| + (1-η) mean|δ|``, the loss ``Σ_t δ²/2``
weighted by the importance weights, then clip by global norm and Adam
(``common.py``). The target net keeps the first weights: it is synced every
2500 steps, after the steps the check follows.

``follow`` retraces a run from the weights the benchmark drew, the unrolls
the run produced, how its set-up filled the replay, and the indices each
batch sampled. It reads as given, as a served model's tokens are read, the
program's draws: the actions, each episode's hidden seed and the sampled
indices; it works out the frames, rewards, ``done`` flags and episode steps
again from the synthetic env's formula (``common.synthetic_env``) and counts
the run's that differ (``env``, which has to be 0). It follows the
program's priorities where it draws the importance weights from them: the
table it computes the weights from holds the priorities the program
inserted and wrote back, which ``insert`` and ``written`` hold against the
reference's own. Everything else it computes itself: the behaviour Q values
and carried state of every rollout (one continuous pass over the global
timesteps, with the weights each was acted with), every insert's initial
priorities, its own model of the replay's slots, the importance weights,
the items each batch must hold, each batch's loss, priorities, gradients
and Adam step. Its readings have the layout of the program's
(``builders/r2d2.py::check_steps``), so ``compare`` takes either.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.harness import check
from perfbench.reference import common

ITEM_LEAVES = ("c", "h", "frames", "prev_action", "reward", "done",
               "observation", "abandoned", "episode_step", "action",
               "q_values")


def parameter_shapes(config) -> Dict[str, tuple]:
    """The net's parameters by the program's names, in its order."""
    net = config["net"]
    h, w = net["frame_shape"]
    cin, actions, lstm = net["stack_size"], net["num_actions"], net["lstm"]
    shapes = {}
    for i, (cout, k, s) in enumerate(net["convs"]):
        shapes[f"torso.convs.{i}.weight"] = (cout, cin, k, k)
        shapes[f"torso.convs.{i}.bias"] = (cout,)
        cin, h, w = cout, (h - k) // s + 1, (w - k) // s + 1
    dense = net["dense"]
    shapes["torso.dense.weight"] = (dense, cin * h * w)
    shapes["torso.dense.bias"] = (dense,)
    shapes["core.cells.0.weight_ih"] = (4 * lstm, dense + 1 + actions)
    shapes["core.cells.0.weight_hh"] = (4 * lstm, lstm)
    shapes["core.cells.0.bias"] = (4 * lstm,)
    hidden = net["head_hidden"]
    shapes["hidden_value.weight"] = (hidden, lstm)
    shapes["hidden_value.bias"] = (hidden,)
    shapes["value_head.weight"] = (1, hidden)
    shapes["value_head.bias"] = (1,)
    shapes["hidden_advantage.weight"] = (hidden, lstm)
    shapes["hidden_advantage.bias"] = (hidden,)
    shapes["advantage_head.weight"] = (actions, hidden)
    return shapes


def stack_frames(obs, done, history):
    """The last S frames at each of T steps ([T, B, H, W, 1] uint8 frames,
    [B, H, W, S-1] history), the history zeroed where ``done`` is set;
    returns the stacks and the history before each step."""
    stacks, before = [], []
    for t in range(obs.shape[0]):
        before.append(history)
        history = history * (~done[t]).to(history.dtype)[:, None, None, None]
        stacked = torch.cat([history, obs[t]], dim=-1)
        stacks.append(stacked)
        history = stacked[..., 1:]
    return torch.stack(stacks), before, history


class Net:
    """DuelingLSTMDQNNet over a dict of parameters at a precision."""

    def __init__(self, config, precision: common.Precision, block: int):
        self.convs = config["net"]["convs"]
        self.num_actions = config["net"]["num_actions"]
        self.q = precision
        self.block = block

    def torso(self, p, stacked):
        q = self.q.torso
        x = q(stacked.permute(0, 3, 1, 2).to(torch.float32) / 255.0)
        for i, (_, _, stride) in enumerate(self.convs):
            x = torch.relu(common.conv(x, p[f"torso.convs.{i}.weight"],
                                       p[f"torso.convs.{i}.bias"], q,
                                       stride=stride))
        x = x.permute(0, 2, 3, 1).flatten(1)
        return torch.relu(common.linear(x, p["torso.dense.weight"],
                                        p["torso.dense.bias"], q))

    def features(self, p, stacked):
        """The torso over [N, ...] stacks, in blocks, without gradients."""
        with torch.no_grad():
            return torch.cat([self.torso(p, stacked[i:i + self.block])
                              for i in range(0, stacked.shape[0],
                                             self.block)])

    def torso_backward(self, p, stacked, grad):
        for i in range(0, stacked.shape[0], self.block):
            self.torso(p, stacked[i:i + self.block]).backward(
                grad[i:i + self.block])

    def core(self, p, features, prev_action, reward, done, carry):
        """The LSTM and dueling heads over time-major [T, B] inputs;
        returns Q, the carry before each step, and the last carry."""
        x = torch.cat([features, reward[..., None],
                       F.one_hot(prev_action.long(), self.num_actions)
                       .to(torch.float32)], dim=-1)
        outputs, carries = [], []
        for t in range(x.shape[0]):
            carries.append(carry)
            carry, h = common.lstm_step(p, "core.cells.0.", x[t], carry,
                                        done[t], self.q.core)
            outputs.append(h)
        h = torch.stack(outputs)
        q = self.q.heads
        value = common.linear(torch.relu(common.linear(
            h, p["hidden_value.weight"], p["hidden_value.bias"], q)),
            p["value_head.weight"], p["value_head.bias"], q)
        advantage = common.linear(torch.relu(common.linear(
            h, p["hidden_advantage.weight"], p["hidden_advantage.bias"], q)),
            p["advantage_head.weight"], None, q)
        return value + advantage - advantage.mean(-1, keepdim=True), \
            carries, carry


def rescale(x, eps):
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def unrescale(x, eps):
    return torch.sign(x) * (torch.square(
        (torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps)) - 1.0)
        / (2.0 * eps)) - 1.0)


def n_step_targets(rewards, done, bootstrap, gamma, n):
    """``G_t = Σ_{i<n} γ^i (Π_{j<i} (1-d_{t+j})) r_{t+i} + γ^n (Π (1-d))
    Q_{t+n-1}`` over [T, B], ``bootstrap[t] = Q(s_{t+1})``; past the end
    the rewards are 0, nothing is done, and ``Q_{T-1+k} = Q_{T-1} / γ^k``
    (so the last targets bootstrap from the last Q over fewer steps)."""
    t_len = rewards.shape[0]
    pad = torch.zeros((n,) + tuple(rewards.shape[1:]), dtype=rewards.dtype,
                      device=rewards.device)
    r = torch.cat([rewards, pad])
    d = torch.cat([done.to(rewards.dtype), pad])
    boot = torch.cat([bootstrap] + [bootstrap[-1:] / gamma ** k
                                    for k in range(1, n + 1)])
    total = torch.zeros_like(rewards)
    discount = torch.ones_like(rewards)
    for i in range(n):
        total = total + discount * r[i:i + t_len]
        discount = discount * gamma * (1.0 - d[i:i + t_len])
    return total + discount * boot[n - 1:n - 1 + t_len]


def td_errors(q_taken, q_bootstrap, rewards, done, knobs):
    """``δ_t = h(G_{t+1}) - Q(s_t, a_t)`` over the T-1 steps that have a
    target (``q_bootstrap``: the target net's Q at the online argmax)."""
    eps = knobs["rescaling_epsilon"]
    targets = n_step_targets(rewards.double(), done,
                             unrescale(q_bootstrap.double(), eps),
                             knobs["discounting"], knobs["n_steps"])
    return rescale(targets, eps)[1:].to(q_taken.dtype) - q_taken[:-1]


def priorities(delta, eta):
    a = delta.detach().abs()
    return eta * a.amax(0) + (1.0 - eta) * a.mean(0)


def follow(config, traffic, inputs, precision, device, block: int = 2048):
    """The reference's readings over a run's fill and first steps."""
    knobs, net_knobs = config["learner"], config["net"]
    net = Net(config, precision, block)
    burn, t_len = traffic["burn_in"], traffic["unroll_length"]
    unrolls, env_mismatched = common.synthetic_env(
        config["env"], inputs["unrolls"], burn, device)
    fill, given = inputs["fill"], inputs["priorities"]
    batches = inputs["batches_per_step"]
    training, size = fill["per_insert"], fill["size"]
    fills = fill["real"] // training
    eta, alpha = knobs["eta"], knobs["priority_exponent"]
    beta = knobs["importance_sampling_exponent"]
    params = {n: t.to(device, torch.float32).clone().requires_grad_(True)
              for n, t in inputs["theta0"].items()}
    start = {n: t.detach().clone() for n, t in params.items()}
    target = start
    adam = common.Adam(knobs["learning_rate"], knobs["adam_b1"], 0.999,
                       knobs["adam_epsilon"], knobs["clip_norm"])
    readings: Dict[str, List] = {k: [] for k in (
        "q", "core", "frames", "insert", "weights", "items", "written",
        "batch_loss")}
    readings["env"] = env_mismatched

    num_envs = unrolls[0]["reward"].shape[1]
    h, w = net_knobs["frame_shape"]
    lstm, stack = net_knobs["lstm"], net_knobs["stack_size"]
    zeros = torch.zeros((num_envs, lstm), device=device)
    # The state the behaviour pass has reached, and the one the next unroll
    # starts from (its first timestep is T steps into the last unroll).
    carry = next_carry = (zeros, zeros)
    history = next_history = torch.zeros(
        (num_envs, h, w, stack - 1), dtype=torch.uint8, device=device)
    starts, tail = [], None

    def act(k, p):
        """Unroll ``k``'s new steps acted on with ``p``; returns the initial
        priorities of its training envs' items."""
        nonlocal carry, history, next_carry, next_history, tail
        u = unrolls[k]
        first = 0 if k == 0 else burn + 1
        take = {n: u[n][first:].to(device) for n in (
            "observation", "done", "prev_action", "reward", "action")}
        readings["core"].append(next_carry)
        readings["frames"].append(next_history)
        starts.append((next_carry, next_history))
        stacked, before, history = stack_frames(
            take["observation"], take["done"], history)
        n_steps = stacked.shape[0]
        feats = net.features(p, stacked.flatten(0, 1)).view(n_steps,
                                                            num_envs, -1)
        with torch.no_grad():
            q, carries, carry = net.core(p, feats, take["prev_action"],
                                         take["reward"], take["done"], carry)
        q_all = q if k == 0 else torch.cat([tail, q])
        readings["q"].append(q_all)
        tail = q_all[t_len:]
        at = t_len - first  # this unroll's step T starts the next one
        next_carry, next_history = carries[at], before[at]
        u_action = u["action"][burn:, :training].to(device)
        taken = q_all[burn:, :training].gather(
            -1, u_action.long()[..., None]).squeeze(-1)
        delta = td_errors(taken, taken, u["reward"][burn:, :training]
                          .to(device), u["done"][burn:, :training]
                          .to(device), knobs)
        return priorities(delta, eta)

    # The fill: the real rollouts, then their items again until full. The
    # table the importance weights come from holds the program's
    # priorities, which ``insert`` and ``written`` hold against the
    # reference's own.
    slots_unroll = torch.empty(size, dtype=torch.long)
    slots_env = torch.empty(size, dtype=torch.long)
    prio = torch.zeros(size, dtype=torch.float64)
    for k in range(fills):
        readings["insert"].append(act(k, start))
        lo = k * training
        prio[lo:lo + training] = given["insert"][k].double()
        slots_unroll[lo:lo + training] = k
        slots_env[lo:lo + training] = torch.arange(training)
    real = fill["real"]
    source = (torch.arange(real, size) - real) % real
    prio[real:] = prio[source]
    slots_unroll[real:] = slots_unroll[source]
    slots_env[real:] = slots_env[source]

    cursor, indices = 0, inputs["indices"]
    step_losses = []
    for step in range(len(unrolls) - fills):
        now = {n: t.detach() for n, t in params.items()}
        readings["insert"].append(act(fills + step, now))
        slots = (cursor + torch.arange(training)) % size
        prio[slots] = given["insert"][fills + step].double()
        slots_unroll[slots] = fills + step
        slots_env[slots] = torch.arange(training)
        cursor = (cursor + training) % size
        losses = []
        for b in range(batches):
            idx = indices[step * batches + b].long().cpu()
            probs = prio.pow(alpha)
            probs = probs / probs.sum()
            weights = ((1.0 / size) / probs[idx]).pow(beta)
            weights = (weights / weights.max()).to(torch.float32)
            readings["weights"].append(weights)
            items = _items(unrolls, slots_unroll[idx], slots_env[idx])
            readings["items"].append(items)
            loss, written, grads = _batch(
                net, params, target, starts, slots_unroll[idx],
                slots_env[idx], items, weights.to(device), burn, knobs)
            clipped = adam.step(params, grads)
            if "grad_norms" not in readings:
                readings["grad_norms"] = common.norms(clipped)
                readings["grad"] = clipped
            readings["written"].append(written)
            readings["batch_loss"].append(loss)
            for i, value in zip(idx.tolist(),
                                given["written"][step * batches + b]
                                .double()):
                prio[i] = value  # where an index repeats, the last wins
            losses.append(loss)
        step_losses.append(sum(losses) / len(losses))
    readings["loss"] = step_losses
    readings["change_norms"] = common.norms(
        {n: params[n].detach() - start[n] for n in params})
    return readings


def _items(unrolls, which, env):
    """The replay items at slots holding unroll ``which[i]``'s env
    ``env[i]``, as ``ITEM_LEAVES`` (item-major), from the unrolls as the
    run stored them."""
    out = []
    for leaf in ITEM_LEAVES:
        rows = []
        for k, j in zip(which.tolist(), env.tolist()):
            t = unrolls[k][leaf]
            rows.append(t[j] if leaf in ("c", "h", "frames") else t[:, j])
        out.append(torch.stack(rows))
    return out


def _batch(net, params, target, starts, which, env, items, weights, burn,
           knobs):
    """One batch: burn-in, the double-DQN n-step loss, its priorities and
    gradients, from the reference's own start states."""
    device = weights.device
    leaf = dict(zip(ITEM_LEAVES, items))

    def time_major(name):
        return leaf[name].transpose(0, 1).to(device)

    c = torch.stack([starts[k][0][0][j] for k, j in zip(which.tolist(),
                                                          env.tolist())])
    h = torch.stack([starts[k][0][1][j] for k, j in zip(which.tolist(),
                                                          env.tolist())])
    history = torch.stack([starts[k][1][j] for k, j in zip(which.tolist(),
                                                            env.tolist())])
    obs, done = time_major("observation"), time_major("done")
    prev, reward = time_major("prev_action"), time_major("reward")
    action = time_major("action")
    stacked, _, _ = stack_frames(obs, done, history)
    n_steps, batch = stacked.shape[:2]
    flat = stacked.flatten(0, 1)
    online_feats = net.features(params, flat).view(n_steps, batch, -1)
    target_feats = net.features(target, flat).view(n_steps, batch, -1)
    with torch.no_grad():
        _, _, online_carry = net.core(params, online_feats[:burn],
                                      prev[:burn], reward[:burn],
                                      done[:burn], (c, h))
        _, _, target_carry = net.core(target, target_feats[:burn],
                                      prev[:burn], reward[:burn],
                                      done[:burn], (c, h))
        q_target, _, _ = net.core(target, target_feats[burn:], prev[burn:],
                                  reward[burn:], done[burn:], target_carry)
    feats = online_feats[burn:].clone().requires_grad_(True)
    q_online, _, _ = net.core(params, feats, prev[burn:], reward[burn:],
                              done[burn:], online_carry)
    greedy = q_online.detach().argmax(-1)
    taken = q_online.gather(-1, action[burn:].long()[..., None]).squeeze(-1)
    bootstrap = q_target.gather(-1, greedy[..., None]).squeeze(-1)
    delta = td_errors(taken, bootstrap, reward[burn:], done[burn:], knobs)
    loss = torch.mean(0.5 * torch.sum(torch.square(delta), 0) * weights)
    loss.backward()
    net.torso_backward(params, flat[burn * batch:], feats.grad.flatten(0, 1))
    return (float(loss.detach()), priorities(delta, knobs["eta"]),
            common.take_grads(params))


def compare(program, reference) -> Dict[str, float]:
    """The gaps of ``program``'s readings from ``reference``'s.

    ``env`` counts the elements of the run's env outputs that differ from
    the formula's (the reference's count). ``rollout`` and ``insert`` take
    the unrolls acted on with the drawn weights (the fill's and the first
    step's) and the states carried out of them; ``written`` the first
    batch, which the drawn weights alone decide. ``sample`` counts the
    elements of the sampled items that differ from what was inserted into
    their slots: none may. ``weights``: every batch's importance weights,
    which the reference works out from the program's priorities (held by
    ``insert`` and ``written``), so the formula is held to rounding.
    ``loss_first`` is the first batch's loss, ``grad`` the first
    gradient's worst leaf by its norm and ``grad_cos`` by its direction
    (1 - the cosine of the two, every leaf together). ``change`` follows
    weights that Adam moved by ±lr where a gradient is near zero on either
    side. Each step's loss is not compared: after the first batch it
    follows those moved weights too, and every fault it fails another
    number fails."""
    acted = len(program["insert"]) - len(program["loss"]) + 1
    rollout = max(check.tensor_gap(p, r) for p, r in
                  zip(program["q"][:acted], reference["q"][:acted]))
    rollout = max([rollout] + [
        check.tensor_gap(p, r)
        for pair, ref in zip(program["core"][:acted + 1],
                             reference["core"][:acted + 1])
        for p, r in zip(pair, ref)] + [
        check.tensor_gap(p, r)
        for p, r in zip(program["frames"], reference["frames"])])
    mismatched = sum(
        int((p.to(r.dtype) != r).sum())
        for pb, rb in zip(program["items"], reference["items"])
        for p, r in zip(pb, rb))
    return {
        "env": float(reference["env"]),
        "rollout": rollout,
        "insert": max(check.tensor_gap(p, r) for p, r in zip(
            program["insert"][:acted], reference["insert"][:acted])),
        "sample": float(mismatched),
        "weights": max(check.tensor_gap(p, r) for p, r in zip(
            program["weights"], reference["weights"])),
        "written": check.tensor_gap(program["written"][0],
                                    reference["written"][0]),
        "loss_first": check.scalar_gap(program["batch_loss"][0],
                                       reference["batch_loss"][0]),
        "grad": check.leaf_norm_gap(program["grad_norms"],
                                    reference["grad_norms"]),
        "grad_cos": check.cosine_gap(program["grad"], reference["grad"]),
        "change": check.leaf_norm_gap(
            program["change_norms"], reference["change_norms"],
            check.moving_leaves(reference["grad_norms"])),
    }
