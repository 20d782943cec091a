"""GTrXL, the gated Transformer-XL core, on IMPALA's ResNet torso.

From Parisotto et al., "Stabilizing Transformers for Reinforcement
Learning" (ICML 2020, arXiv:1910.06764), whose attention is
Transformer-XL's (Dai et al., arXiv:1901.02860). ``ImpalaGTrXL`` is
``ImpalaDeep`` with its LSTM replaced: ``ImpalaResNetTorso``, a linear
projection of [torso features, reward clipped to +-1, one-hot previous
action] to the model width, the GTrXL layers, then the policy and baseline
heads. Layer l, with E its input for the queried rows and M its memory of
earlier inputs:

- ``Ȳ = RelMHA(LayerNorm([sg(M), E]))``, Transformer-XL's relative
  attention: ``A_ij = (q_i + u)·k_j + (q_i + v)·W_kR R_{i-j}``, scaled by
  ``1/sqrt(head_size)``, R the sinusoids of the distance ``i - j`` and u,
  v learned per head (and per layer); the heads' outputs are projected
  back to the model width;
- ``Y = g(E, ReLU(Ȳ))`` and ``E' = g(Y, ReLU(MLP(LayerNorm(Y))))``, with
  the GRU-type gate ``r = σ(W_r y + U_r x)``, ``z = σ(W_z y + U_z x - b_g)``,
  ``ĥ = tanh(W_g y + U_g (r ⊙ x))``, ``g(x, y) = (1 - z) ⊙ x + z ⊙ ĥ``.

Each query attends to itself and its ``memory_length`` predecessors within
its own episode, in acting (``forward``, one step on ``[B]``) and in
learning (``unroll``, a segment on ``[T, B]`` in one pass a layer) alike,
so the two compute one function of the weights.

The state (``GTrXLState``) holds, per layer, a ring of the last
``memory_length + 1`` layer inputs of each env (the row a step writes and
the ``memory_length`` before it), the step each env acts next and the step
its episode began. ``done`` masks the keys before that step; it selects no
new state. Acting writes its row into the ring in place (the rollout
engines copy the state they keep for an unroll), at the slot
``time % (memory_length + 1)``; the distances and the episode mask follow
from the times, so a CUDA graph replays them from device tensors.
``unroll`` reads the ring in time order and returns the state after the
segment as a new ring.

The attention runs in ``scaled_dot_product_attention`` (on the card its
memory-efficient kernels, ``fmha_cutlass*``), with the key projection
folded into the query and the value projection applied after the
weighting: ``(q + u)·W_k h = (W_kᵀ (q + u))·h`` and
``Σ p W_v h = W_v Σ p h``. So the keys and values are the layer-normed rows ``h`` themselves, read once
for all heads (the heads are the queries' rows), and no key or value of a
memory row is computed; the distance term enters as the attention's
additive mask, beside the episode's.

Compute dtypes: ``dtype`` is the torso's, as in ``ImpalaDeep``;
``core_dtype`` is the core's projections and attention products (f32
accumulation) and the memory's storage type. LayerNorm computes in f32 (on
rows stored or rounded to ``core_dtype``, the same rows in acting and
learning, its gain and bias cast to their type), and so do the softmax and
the gates' nonlinearities; the residual stream and the heads are f32.

``counters`` holds three device tensors that acting updates in place
(no host sync, so a CUDA graph's replay counts too): the queries acted
(env steps), the keys they attended (summed over queries; at most
``memory_length + 1`` each) and the envs whose episode restarted.
"""

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.core import dense, lecun_normal_
from seed_rl_torch.models.policy import _generator
from seed_rl_torch.models.resnets import ImpalaResNetTorso, core_inputs
from seed_rl_torch.utils.profiling import span


class GTrXLState(NamedTuple):
    memory: Tuple[torch.Tensor, ...]  # per layer [B, memory_length + 1, d]
    time: torch.Tensor  # i64[B]: the step each env acts next
    episode_start: torch.Tensor  # i64[B]: the step its episode began


def sinusoids(distances: torch.Tensor, width: int) -> torch.Tensor:
    """Transformer-XL's position table: ``[sin(d f_k), cos(d f_k)]`` with
    ``f_k = 10000^(-2k / width)``, f32 ``[N, width]``."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, width, 2, dtype=torch.float32, device=distances.device) / width))
    angles = distances.to(torch.float32)[:, None] * inv_freq
    return torch.cat([angles.sin(), angles.cos()], dim=-1)


def _linear(x, weight, dtype, bias=None):
    """``x @ weight.T (+ bias)`` with every operand in ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


def _layer_norm(norm: nn.LayerNorm, x):
    """``norm(x)`` with its gain and bias in ``x``'s type: the statistics
    and the normalization compute in f32 whatever that type (PyTorch's
    kernel accumulates a bf16 row in f32)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _attention(q, k, v, mask, scale):
    """``softmax(q kᵀ scale + mask) v``; on the card only by the
    memory-efficient kernels, so the trace names them."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=scale)


class GRUGate(nn.Module):
    """``g(x, y)``: ``weight_y`` stacks W_r, W_z, W_g; ``weight_x`` stacks
    U_r, U_z; ``weight_rx`` is U_g; ``bias`` is b_g."""

    def __init__(self, width: int, gate_bias: float,
                 generator: torch.Generator):
        super().__init__()
        self.weight_y = nn.Parameter(torch.empty(3 * width, width))
        self.weight_x = nn.Parameter(torch.empty(2 * width, width))
        self.weight_rx = nn.Parameter(torch.empty(width, width))
        self.bias = nn.Parameter(torch.full((width,), gate_bias))
        for weight in (self.weight_y, self.weight_x, self.weight_rx):
            lecun_normal_(weight, generator)

    def forward(self, x, y, dtype):
        wr, wz, wg = _linear(y, self.weight_y, dtype).float().chunk(3, -1)
        ur, uz = _linear(x, self.weight_x, dtype).float().chunk(2, -1)
        r = torch.sigmoid(wr + ur)
        z = torch.sigmoid(wz + uz - self.bias)
        h = torch.tanh(wg + _linear(r * x, self.weight_rx, dtype).float())
        return (1.0 - z) * x + z * h


class GTrXLLayer(nn.Module):
    """One gated layer: relative attention, then the MLP, each behind its
    LayerNorm and its gate."""

    def __init__(self, width: int, num_heads: int, head_size: int,
                 mlp_size: int, gate_bias: float,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads, self.head_size = num_heads, head_size
        inner = num_heads * head_size
        self.norm1 = nn.LayerNorm(width)
        self.query = nn.Parameter(torch.empty(inner, width))
        self.key = nn.Parameter(torch.empty(inner, width))
        self.value = nn.Parameter(torch.empty(inner, width))
        self.position = nn.Parameter(torch.empty(inner, width))  # W_kR
        self.content_bias = nn.Parameter(torch.zeros(num_heads, head_size))
        self.position_bias = nn.Parameter(torch.zeros(num_heads, head_size))
        self.out = nn.Parameter(torch.empty(width, inner))
        for weight in (self.query, self.key, self.value, self.position,
                       self.out):
            lecun_normal_(weight, generator)
        self.gate1 = GRUGate(width, gate_bias, generator)
        self.norm2 = nn.LayerNorm(width)
        self.mlp1 = dense(width, mlp_size, generator)
        self.mlp2 = dense(mlp_size, width, generator)
        self.gate2 = GRUGate(width, gate_bias, generator)

    def attend(self, h, h_query, positions, distance, valid, dtype):
        """Relative attention of the rows ``h_query`` [B, Q, d] over the
        rows ``h`` [B, K, d] (both layer-normed, in ``dtype``): ``distance``
        [B or 1, Q, K] indexes ``positions`` (the table R over distances
        0..memory_length), ``valid`` [B, Q, K] is the window and episode
        mask. Returns Ȳ [B, Q, d] in f32."""
        batch, queries, width = h_query.shape
        heads, size = self.num_heads, self.head_size
        q = _linear(h_query, self.query, dtype).view(batch, queries, heads,
                                                     size)
        # (q + u)·(W_k h) as (W_kᵀ (q + u))·h: a width-d query row a head.
        folded = torch.einsum("bqhe,hed->bqhd",
                              q + self.content_bias.to(dtype),
                              self.key.to(dtype).view(heads, size, width))
        r = _linear(positions, self.position, dtype).view(-1, heads, size)
        by_distance = torch.einsum("bqhe,khe->bqhk",
                                   q + self.position_bias.to(dtype), r)
        index = distance[:, :, None, :].expand(batch, queries, heads,
                                               h.shape[1])
        scale = 1.0 / math.sqrt(size)
        mask = torch.where(valid[:, :, None, :],
                           by_distance.gather(-1, index) * scale,
                           float("-inf"))
        weighted = _attention(
            folded.reshape(batch, 1, queries * heads, width),
            h[:, None], h[:, None],
            mask.reshape(batch, 1, queries * heads, h.shape[1]), scale)
        o = torch.einsum("bqhd,hed->bqhe",
                         weighted.reshape(batch, queries, heads, width),
                         self.value.to(dtype).view(heads, size, width))
        return _linear(o.reshape(batch, queries, heads * size), self.out,
                       dtype).float()

    def forward(self, e, h, h_query, positions, distance, valid, dtype):
        """The layer's output for the queried rows ``e`` [B, Q, d] (f32)."""
        y = self.gate1(e, torch.relu(self.attend(
            h, h_query, positions, distance, valid, dtype)), dtype)
        m = torch.relu(_linear(_layer_norm(self.norm2, y), self.mlp1.weight,
                               dtype, self.mlp1.bias))
        m = _linear(m, self.mlp2.weight, dtype, self.mlp2.bias).float()
        return self.gate2(y, torch.relu(m), dtype)


class ImpalaGTrXL(nn.Module):
    """IMPALA's ResNet torso with a GTrXL core and ``ImpalaDeep``'s heads.

    ``forward(prev_action, env_output, core_state)`` on ``[B]`` inputs and
    ``unroll`` on time-major ``[T, B]`` inputs return
    ``((policy_logits, baseline), core_state)``; the core state is a
    ``GTrXLState``. The defaults are the paper's DMLab-30 widths.
    """

    stateless = False

    def __init__(
        self,
        num_actions: int,
        observation_shape: Tuple[int, int, int],
        num_layers: int = 12,
        model_size: int = 256,
        num_heads: int = 8,
        head_size: int = 64,
        memory_length: int = 512,
        mlp_size: int = 1024,
        gate_bias: float = 2.0,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        core_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.num_actions = num_actions
        self.model_size = model_size
        self.memory_length = memory_length
        self.remat = remat
        self.core_dtype = core_dtype
        self.torso = ImpalaResNetTorso(tuple(observation_shape), generator,
                                       dtype=dtype)
        self.embed = dense(self.torso.dense.out_features + 1 + num_actions,
                           model_size, generator)
        self.layers = nn.ModuleList(
            GTrXLLayer(model_size, num_heads, head_size, mlp_size, gate_bias,
                       generator) for _ in range(num_layers))
        self.policy_logits = dense(model_size, num_actions, generator)
        self.baseline = dense(model_size, 1, generator)
        self.register_buffer(
            "positions",
            sinusoids(torch.arange(memory_length + 1), model_size),
            persistent=False)
        self.to(device)
        self.counters = {name: torch.zeros((), dtype=torch.int64,
                                           device=device)
                         for name in ("queries", "keys", "restarts")}

    @property
    def ring(self) -> int:
        return self.memory_length + 1

    def initial_state(self, batch_size: int) -> GTrXLState:
        device = self.positions.device
        zeros = torch.zeros((batch_size,), dtype=torch.int64, device=device)
        return GTrXLState(
            memory=tuple(torch.zeros((batch_size, self.ring, self.model_size),
                                     dtype=self.core_dtype, device=device)
                         for _ in self.layers),
            time=zeros, episode_start=zeros.clone())

    def _heads(self, x):
        return self.policy_logits(x), self.baseline(x).squeeze(-1)

    def _embed(self, prev_action, env_output, batch_dims):
        x = core_inputs(self.torso, self.num_actions, prev_action,
                        env_output, batch_dims, self.remat)
        return _linear(x, self.embed.weight, self.core_dtype,
                       self.embed.bias).float()

    def forward(self, prev_action, env_output, core_state: GTrXLState):
        """One acting step: each env's row joins its ring in place."""
        e = self._embed(prev_action, env_output, 1)
        with span("core"):
            e, core_state = self._act(e, env_output.done, core_state)
        return self._heads(e), core_state

    def _act(self, e, done, state: GTrXLState):
        time = state.time
        rows = torch.arange(e.shape[0], device=e.device)
        with span("core.memory"):
            start = torch.where(done, time, state.episode_start)
            slot = time % self.ring
            # After the write, slot k holds the row of step time - distance.
            distance = (time[:, None] - torch.arange(
                self.ring, device=e.device)) % self.ring
            valid = distance <= (time - start)[:, None]
            self.counters["queries"] += e.shape[0]
            self.counters["keys"] += valid.sum()
            self.counters["restarts"] += done.sum()
        e = e[:, None]
        for layer, memory in zip(self.layers, state.memory):
            with span("core.memory"):
                memory[rows, slot] = e[:, 0].detach().to(memory.dtype)
            h = _layer_norm(layer.norm1, memory)
            e = layer(e, h, h[rows, slot][:, None], self.positions,
                      distance[:, None], valid[:, None], self.core_dtype)
        return e[:, 0], GTrXLState(state.memory, time + 1, start)

    def unroll(self, prev_actions, env_outputs, core_state: GTrXLState):
        """The [T, B] training path: the segment in one pass a layer
        against the memory ``core_state`` holds (stop-gradient)."""
        e = self._embed(prev_actions, env_outputs, 2)
        with span("core"):
            e, core_state = self._segment(e.transpose(0, 1),
                                          env_outputs.done.transpose(0, 1),
                                          core_state)
        return self._heads(e.transpose(0, 1)), core_state

    def _segment(self, e, done, state: GTrXLState):
        batch, length, _ = e.shape
        ring, device = self.ring, e.device
        t0 = state.time
        steps = torch.arange(length, device=device)
        # The step each query's episode began.
        starts = torch.where(done, t0[:, None] + steps, -1).cummax(1).values
        starts = torch.maximum(starts, state.episode_start[:, None])
        # Keys: the ring in time order (steps t0 - ring .. t0 - 1), then
        # the segment's rows; key j is at step t0 + j - ring.
        relative = torch.arange(-ring, length, device=device)
        distance = steps[:, None] - relative
        valid = ((distance >= 0) & (distance <= self.memory_length))[None] & (
            (t0[:, None] + relative)[:, None, :] >= starts[:, :, None])
        distance = distance.clamp(0, self.memory_length)[None]
        rows = torch.arange(batch, device=device)[:, None]
        slots = torch.arange(ring, device=device)
        in_time_order = (t0[:, None] + slots) % ring
        after = (slots - (t0 + length)[:, None]) % ring
        memory = []
        for layer, ring_rows in zip(self.layers, state.memory):
            keys = torch.cat([ring_rows[rows, in_time_order].detach(),
                              e.to(ring_rows.dtype)], dim=1)
            with torch.no_grad():
                memory.append(keys[:, length:][rows, after])
            h = _layer_norm(layer.norm1, keys)
            e = layer(e, h, h[:, ring:], self.positions, distance, valid,
                      self.core_dtype)
        return e, GTrXLState(tuple(memory), t0 + length, starts[:, -1])
