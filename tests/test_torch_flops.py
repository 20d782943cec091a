"""The port's FLOPs models (seed_rl_torch/utils/flops.py) against the JAX
package's (seed_rl_tpu/utils/flops.py).

Both modules are plain Python integer arithmetic, so every function must
give exactly the JAX module's value over a grid of arguments: the defaults,
the bench's own shapes and off-default widths. The port's module also
carries the H100's peak rates, and no figure of a TPU.
"""

import inspect
import itertools
import pathlib

import pytest
import torch

from seed_rl_torch.utils import flops
from seed_rl_tpu.utils import flops as jax_flops


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in every port test file (see
    tests/test_torch_ppo.py): the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FUNCTIONS = sorted(
    name for name, fn in inspect.getmembers(jax_flops, inspect.isfunction)
    if fn.__module__ == jax_flops.__name__)

GRIDS = {
    "conv2d": [dict(out_h=h, out_w=w, cin=c, cout=o, k=k)
               for h, w, c, o, k in itertools.product(
                   (1, 7, 20), (1, 9, 48), (1, 4, 32), (16, 64), (1, 3, 8))],
    "dense": [dict(cin=a, cout=b) for a, b in itertools.product(
        (1, 4, 513, 3136), (1, 6, 256, 512))],
    "lstm": [dict(in_size=a, hidden=b) for a, b in itertools.product(
        (1, 266, 531), (16, 256, 512))],
    "_valid_out": [dict(size=s, k=k, s=st) for s, k, st in itertools.product(
        (8, 20, 84, 96), (3, 4, 8), (1, 2, 4))],
    "nature_torso": [dict()] + [dict(h=h, w=w, cin=c) for h, w, c in
                                itertools.product((36, 84), (36, 84, 90),
                                                  (1, 4))],
    "atari_policy_net": [dict(num_actions=a, lstm_size=n, stack_size=s)
                         for a, n, s in itertools.product(
                             (3, 18), (0, 256), (1, 4))],
    "dueling_lstm_dqn_net": [dict(num_actions=a, lstm_size=n, stack_size=s)
                             for a, n, s in itertools.product(
                                 (3, 18), (32, 512), (1, 4))],
    "impala_resnet_torso": [
        dict(h=72, w=96, cin=3), dict(h=84, w=84, cin=1, dense_out=128),
        dict(h=72, w=96, cin=4,
             stacks=((16, 2), (32, 2), (32, 2), (32, 2))),
        dict(h=23, w=17, cin=2, stacks=((8, 1),)),
    ],
    "impala_deep": [dict()] + [dict(num_actions=a, h=h, w=w, cin=c,
                                    lstm_size=n)
                               for a, (h, w), c, n in itertools.product(
                                   (3, 9), ((72, 96), (84, 84)), (1, 3),
                                   (16, 256))],
    "gfootball_net": [dict(num_action_params=p, h=h, w=w, planes=q)
                      for p, (h, w), q in itertools.product(
                          (19, 6), ((72, 96), (18, 24)), (4, 16))],
    "visual_actor_critic": [
        dict(param_size=p, action_dim=a, n_critics=n, head_sizes=hs, h=h,
             w=w, cin=c)
        for p, a, n, hs, (h, w, c) in itertools.product(
            (2, 4), (1, 2), (1, 2), ((256,), (16, 32)),
            ((84, 84, 1), (42, 42, 3)))],
}


def _sac_grid():
    comps = [jax_flops.visual_actor_critic(param_size=2, action_dim=1),
             jax_flops.visual_actor_critic(param_size=4, action_dim=2,
                                           head_sizes=(16,), h=42, w=42)]
    return [dict(comp=c, unroll=u, env_frames_per_step=e, batch_size=b,
                 minibatches=m)
            for c, u, e, b, m in itertools.product(
                comps, (1, 2, 8), (1024, 64), (1024, 16), (1, 4))]


GRIDS["sac_visual_flops_per_env_frame"] = _sac_grid()


# The models of scripts/profile_impala.py, which the port's module also
# holds (held against the script in tests/test_torch_tools.py).
SCRIPT_MODELS = ["impala_flops_per_frame", "impala_hbm_bytes_per_frame"]


def test_the_port_has_every_function_of_the_jax_module():
    port = sorted(
        name for name, fn in inspect.getmembers(flops, inspect.isfunction)
        if fn.__module__ == flops.__name__)
    assert port == sorted(FUNCTIONS + SCRIPT_MODELS)
    assert set(GRIDS) == set(FUNCTIONS)
    assert flops.BWD_MULT == jax_flops.BWD_MULT


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_equals_the_jax_modules(name):
    assert (inspect.signature(getattr(flops, name))
            == inspect.signature(getattr(jax_flops, name)))
    for kwargs in GRIDS[name]:
        got = getattr(flops, name)(**kwargs)
        want = getattr(jax_flops, name)(**kwargs)
        assert got == want, (name, kwargs)
        assert type(got) is type(want), (name, kwargs)


def test_peaks_are_the_h100_sxm5_data_sheets_and_no_tpu_figure():
    assert flops.PEAK_BF16_FLOPS == 989e12
    assert flops.PEAK_TF32_FLOPS == 495e12
    assert flops.PEAK_FP32_FLOPS == 67e12
    assert flops.HBM_BYTES_PER_S == 3.35e12
    text = pathlib.Path(flops.__file__).read_text()
    assert "H100 SXM5" in text
    for tpu_figure in ("197", "819", "v5e", "MXU"):
        assert tpu_figure not in text, tpu_figure
