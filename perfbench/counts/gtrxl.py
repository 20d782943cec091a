"""Frozen counts of GTrXL on IMPALA's torso under V-trace: a train step's
model FLOPs (``step_mfu``) and the bound of its attention
(``core_attention_roofline``).

Model FLOPs (a multiply-accumulate is 2, as ``flops.py`` counts; a trained
row costs 3 forwards):
- acting, a frame: the torso, the input projection, a layer's query row
  (its query, key and value projections, the attention over the valid
  keys, the output projection, the two gates, the MLP), the heads. The key
  and value of a memory row are left out of acting: a cache keeps them.
- the update, an env's unroll of T + 1 rows: the torso and the layers'
  rows as in acting, plus the keys and values of the ``memory_length``
  memory rows a layer (the weights moved since they were acted), and the
  attention over each query's valid keys.
The distance table's projection, shared by every env, is left out.

The attention's bound, a train step: acting,
``max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s)`` with the bytes the memory's
rows read once a step (``memory_length`` rows a layer and env, in the
core's type: the least any design reads) and the FLOPs the q·k, q·R and
p·v products over the valid keys; the update, those products' FLOPs,
forward and backward. The valid keys are their mean over one of the
traffic's lockstep episodes (``mean_keys``: 381.67 of 513, 74.4%, for
1,000-step episodes and a memory of 512). A window covers two or three
episodes, so its phase moves the true fill by some points; acting's bound
is its bytes (15.4 ms a step at 512 envs against 0.23 ms of FLOPs), which
no fill moves, so the bound stays under the work whatever the phase.
"""

from perfbench.counts.flops import (
    HBM_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    dense,
    impala_resnet_torso,
)

# The attention's kernels on the card: PyTorch's memory-efficient
# ``scaled_dot_product_attention`` (CUTLASS's ``fmha_cutlassF_*`` forward,
# ``fmha_cutlassB_*`` backward).
ATTENTION_KERNELS = "fmha_cutlass"
BYTES = {"bfloat16": 2, "float32": 4}


def mean_keys(memory_length: int, episode_length: int) -> float:
    """The keys a query attends, itself included, on average over an
    episode that starts with an empty memory: ``min(t, M) + 1`` at its
    step t."""
    return sum(min(t, memory_length) + 1
               for t in range(episode_length)) / episode_length


def _widths(config):
    net = config["net"]
    return (net["model_size"], net["num_heads"] * net["head_size"],
            net["mlp_size"], net["num_layers"], net["memory_length"])


def attention_flops(config, keys: float) -> float:
    """q·k, q·R and p·v of one query row over ``keys`` keys, every layer."""
    _, inner, _, layers, _ = _widths(config)
    return layers * 3 * 2 * inner * keys


def row_flops(config) -> float:
    """A layer's work on one queried row but its attention, every layer:
    query, key and value projections, the output projection, two gates
    (W and U of r, z and ĥ), the MLP."""
    d, inner, mlp, layers, _ = _widths(config)
    return layers * (3 * dense(d, inner) + dense(inner, d)
                     + 2 * 6 * dense(d, d) + dense(d, mlp) + dense(mlp, d))


def frame_flops(config) -> float:
    """The torso, the input projection and the heads, a frame."""
    net = config["net"]
    h, w, c = net["frame_shape"]
    d, actions = net["model_size"], net["num_actions"]
    return (impala_resnet_torso(h, w, c, [tuple(s) for s in net["stacks"]],
                                net["dense"])
            + dense(net["dense"] + 1 + actions, d) + dense(d, actions)
            + dense(d, 1))


def _keys(config) -> float:
    return mean_keys(config["net"]["memory_length"],
                     config["env"]["episode_length"])


def step_flops(config, traffic) -> float:
    """Model FLOPs of a train step: T env steps of acting on every env,
    then the update on the T + 1 rows of each env's unroll."""
    envs, t = traffic["num_envs"], traffic["unroll_length"]
    d, inner, _, layers, memory = _widths(config)
    keys = _keys(config)
    per_row = frame_flops(config) + row_flops(config) + attention_flops(
        config, keys)
    acting = t * envs * per_row
    memory_kv = layers * memory * 2 * dense(d, inner)
    update = 3 * envs * ((t + 1) * per_row + memory_kv)
    return acting + update


def attention_seconds(config, traffic) -> float:
    """The attention's bound a train step (module docstring)."""
    envs, t = traffic["num_envs"], traffic["unroll_length"]
    d, _, _, layers, memory = _widths(config)
    element = BYTES[config["compute_dtypes"]["core"]]
    flops = attention_flops(config, _keys(config))
    acting = max(t * envs * layers * memory * d * element / HBM_BYTES_PER_S,
                 t * envs * flops / PEAK_BF16_FLOPS)
    update = 3 * envs * (t + 1) * flops / PEAK_BF16_FLOPS
    return acting + update
