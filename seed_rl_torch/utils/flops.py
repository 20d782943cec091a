"""Analytic FLOPs models of the bench nets, and the H100's peak rates.

Port of ``seed_rl_tpu/utils/flops.py`` (the port keeps its own copy: it
imports nothing of the JAX package). Every function, its name and its
counting convention are the JAX module's, so ``seed_rl_torch/bench.py``
computes

    mfu = fps * flops_per_env_frame / peak_flops

per workload as ``bench.py`` does. The models count forward-pass FLOPs per
frame from the layer shapes (convs as 2*MACs at the output resolution,
dense as 2*in*out, LSTM as 4 gates of 2*(in+hidden)*hidden). Counting
convention: multiply-accumulate = 2 FLOPs; bias, activation, pooling and
normalization terms are omitted (<1% for every net here: the FLOPs are in
the matrix products and convolutions, which is what the tensor cores run).

Backward passes are modeled as 2x forward (grad wrt inputs + grad wrt
weights, each itself a conv/matmul of the forward's cost), the standard
fwd:bwd = 1:2 accounting; so one train pass (fwd+bwd) = 3 fwd-equivalents.

Peak rates of one NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's H100 Tensor
Core GPU data sheet: dense rates (without structured sparsity) at the SXM5
board's 700 W power limit. A card set to a lower limit runs slower under
load, so a measured ``mfu`` is read beside the card's limit.
"""

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet, dense, at 700 W.
PEAK_BF16_FLOPS = 989e12  # BF16 tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3

BWD_MULT = 2.0  # backward = 2x forward FLOPs (dx + dw)


def conv2d(out_h: int, out_w: int, cin: int, cout: int, k: int) -> int:
    return out_h * out_w * cout * cin * k * k * 2


def dense(cin: int, cout: int) -> int:
    return cin * cout * 2


def lstm(in_size: int, hidden: int) -> int:
    return 4 * (in_size + hidden) * hidden * 2


def _valid_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


def nature_torso(h: int = 84, w: int = 84, cin: int = 4) -> int:
    """AtariConvTorso: (32,8,4)(64,4,2)(64,3,1) VALID + Dense 512."""
    total = 0
    for cout, k, s in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
        oh, ow = _valid_out(h, k, s), _valid_out(w, k, s)
        total += conv2d(oh, ow, cin, cout, k)
        h, w, cin = oh, ow, cout
    total += dense(h * w * cin, 512)
    return total


def atari_policy_net(num_actions: int, lstm_size: int = 256,
                     stack_size: int = 4) -> int:
    """AtariPolicyNet fwd FLOPs per frame (torso + LSTM + heads)."""
    total = nature_torso(cin=stack_size)
    if lstm_size:
        total += lstm(512 + 1 + num_actions, lstm_size)
        head_in = lstm_size
    else:
        head_in = 512 + 1 + num_actions
    total += dense(head_in, num_actions) + dense(head_in, 1)
    return total


def dueling_lstm_dqn_net(num_actions: int, lstm_size: int = 512,
                         stack_size: int = 4) -> int:
    """DuelingLSTMDQNNet fwd FLOPs per frame."""
    total = nature_torso(cin=stack_size)
    total += lstm(512 + 1 + num_actions, lstm_size)
    total += dense(lstm_size, 512) + dense(512, 1)       # value branch
    total += dense(lstm_size, 512) + dense(512, num_actions)  # advantage
    return total


def impala_resnet_torso(
    h: int, w: int, cin: int,
    stacks: Sequence[Tuple[int, int]] = ((16, 2), (32, 2), (32, 2)),
    dense_out: int = 256,
) -> int:
    """ImpalaResNetTorso (SAME convs, maxpool /2 between stacks)."""
    total = 0
    for ch, blocks in stacks:
        total += conv2d(h, w, cin, ch, 3)  # downscale conv at full res
        h, w = (h + 1) // 2, (w + 1) // 2
        total += blocks * 2 * conv2d(h, w, ch, ch, 3)
        cin = ch
    total += dense(h * w * cin, dense_out)
    return total


def impala_deep(num_actions: int = 9, h: int = 72, w: int = 96,
                cin: int = 3, lstm_size: int = 256) -> int:
    """ImpalaDeep fwd FLOPs per frame (DmLab agent)."""
    total = impala_resnet_torso(h, w, cin)
    total += lstm(256 + 1 + num_actions, lstm_size)
    total += dense(lstm_size, num_actions) + dense(lstm_size, 1)
    return total


def gfootball_net(num_action_params: int, h: int = 72, w: int = 96,
                  planes: int = 4) -> int:
    """GFootball 4-stack resnet fwd FLOPs per frame (unpacked SMM obs)."""
    total = impala_resnet_torso(
        h, w, planes,
        stacks=((16, 2), (32, 2), (32, 2), (32, 2)),
    )
    total += dense(256, num_action_params) + dense(256, 1)
    return total


def visual_actor_critic(
    param_size: int, action_dim: int, n_critics: int = 2,
    head_sizes: Sequence[int] = (256,), h: int = 84, w: int = 84,
    cin: int = 1,
) -> Dict[str, int]:
    """VisualActorCritic per-frame fwd FLOPs, split by component.

    Returns {"torso": ..., "actor": ..., "v": ..., "q": ...} so callers can
    assemble pass counts that match the loss structure (the torso may be
    shared across heads or re-run per head depending on the loss path).
    """
    def mlp(in_size, out):
        total, c = 0, in_size
        for hdim in head_sizes:
            total += dense(c, hdim)
            c = hdim
        return total + dense(c, out)

    emb = 512
    return {
        "torso": nature_torso(h, w, cin),
        "actor": mlp(emb, param_size),
        "v": mlp(emb, 1),
        "q": n_critics * mlp(emb + action_dim, 1),
    }


def sac_visual_flops_per_env_frame(
    comp: Dict[str, int], unroll: int, env_frames_per_step: int,
    batch_size: int, minibatches: int,
) -> float:
    """FLOPs per env frame for the fused visual-SAC step (shared-encoder
    loss: the torso embedding is computed ONCE per net per minibatch and
    reused by the actor/V/Q heads — agents/sac.py compute_loss).

    Per minibatch (batch_size unrolls of T+1 steps, T=unroll trained):
      online embed  : T*B frames fwd+bwd            (3x torso)
      target embed  : (T+1)*B frames fwd            (1x torso)
      actor,V heads : T*B fwd+bwd                   (3x each)
      Q heads       : q(sg) fwd + dQ/da fwd+bwd + q_old fwd+bwd  (~7x q)
      bootstrap V   : (T+1)*B target V head fwd
    Rollout: 1 torso + actor fwd per env frame.
    """
    t, b = unroll, batch_size
    per_mb = (
        t * b * 3 * comp["torso"]
        + (t + 1) * b * comp["torso"]
        + t * b * 3 * (comp["actor"] + comp["v"])
        + t * b * 7 * comp["q"]
        + (t + 1) * b * comp["v"]
    )
    rollout = env_frames_per_step * (comp["torso"] + comp["actor"])
    return (rollout + minibatches * per_mb) / env_frames_per_step


def impala_flops_per_frame(h=72, w=96, cin=3,
                           stacks=((16, 2), (32, 2), (32, 2)),
                           dense_out=256, lstm=256, num_actions=9):
    """Forward FLOPs per frame of ImpalaDeep and their split, ``(total,
    {"stack<i>(<ch>ch)", "dense", "lstm", "heads": FLOPs})``: the model of
    ``scripts/profile_impala.py``, which ``impala_deep`` sums the same
    way (SAME 3x3 convs, the downscale conv at the stack's input
    resolution)."""
    total = 0
    detail = {}
    x_h, x_w, c = h, w, cin
    for i, (ch, blocks) in enumerate(stacks):
        f = conv2d(x_h, x_w, c, ch, 3)  # downscale conv (pre-pool)
        x_h, x_w = (x_h + 1) // 2, (x_w + 1) // 2
        f += blocks * 2 * conv2d(x_h, x_w, ch, ch, 3)
        detail[f"stack{i}({ch}ch)"] = f
        total += f
        c = ch
    detail["dense"] = dense(x_h * x_w * c, dense_out)
    # 4 gates over [torso, reward, one-hot action] and the hidden state.
    detail["lstm"] = 4 * (dense_out + 1 + num_actions + lstm) * lstm * 2
    detail["heads"] = dense(lstm, num_actions + 1)
    total += detail["dense"] + detail["lstm"] + detail["heads"]
    return total, detail


def impala_hbm_bytes_per_frame(h=72, w=96, cin=3,
                               stacks=((16, 2), (32, 2), (32, 2)),
                               bytes_per_el=2):
    """Activation bytes per frame that ImpalaDeep's torso forward moves
    through device memory (``scripts/profile_impala.py``'s model): each
    conv reads its input and writes its output, the pool reads its input
    and writes a quarter; the weights are small and stay in cache."""
    total = 0
    x_h, x_w, c = h, w, cin
    for ch, blocks in stacks:
        total += x_h * x_w * (c + ch) * bytes_per_el  # downscale conv
        total += x_h * x_w * ch * bytes_per_el  # pool read
        x_h, x_w = (x_h + 1) // 2, (x_w + 1) // 2
        total += x_h * x_w * ch * bytes_per_el  # pool write
        total += blocks * 2 * 2 * x_h * x_w * ch * bytes_per_el
        c = ch
    return total

