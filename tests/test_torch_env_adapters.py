"""The real-env adapters of seed_rl_torch against the JAX package, as far
as they run without ALE, DeepMind Lab or gfootball.

Mirrors the cases of tests/test_env_adapters.py that need none of them:
- Football: ``PackedBitsObservation`` packs as JAX's, and ``unpackbits``
  on torch tensors gives JAX's planes exactly; ``GFootball`` (flax
  parameters carried over with ``models/convert.py``) on packed frames
  gives JAX's logits and baseline within rtol 1e-4 / atol 1e-5;
- Atari: ``pool_and_resize_frames`` (max pool, then cv2 INTER_LINEAR)
  equals JAX's byte for byte, and ``AtariPreprocessing`` step for step on
  a scripted ALE stand-in (no-ops, frame skip, life loss);
  ``create_environment`` raises JAX's ``ImportError`` without ``ale_py``;
- DmLab: the registry, the score anchors and the human-normalized score
  equal JAX's; the level cache's fetch / write contract;
- ``SyntheticDmLabEnv`` shapes; and the CLI on ``atari``, ``dmlab`` and
  ``football`` raises the packages' ``ImportError`` advice.
"""

import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_rl_tpu.envs import atari as jax_atari
from seed_rl_tpu.envs import dmlab as jax_dmlab
from seed_rl_tpu.envs import football as jax_football
from seed_rl_tpu.models import resnets as jax_resnets
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import train
from seed_rl_torch.envs import BatchedEnv, SyntheticDmLabEnv, atari, dmlab
from seed_rl_torch.envs import football
from seed_rl_torch.models import GFootball, convert
from seed_rl_torch.types import EnvOutput

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_football_bitpack_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    planes = rng.randint(0, 2, (7, 5, 35)).astype(np.uint8)

    class Planes:
        observation_space = gym.spaces.Box(0, 1, (7, 5, 35), np.uint8)
        action_space = gym.spaces.Discrete(19)

    wrapper = football.PackedBitsObservation(Planes())
    assert wrapper.observation_space.shape == (7, 5, 3)
    assert wrapper.observation_space.dtype == np.uint16
    jwrapper = jax_football.PackedBitsObservation.__new__(
        jax_football.PackedBitsObservation)
    packed = wrapper.observation(planes)
    want = jax_football.PackedBitsObservation.observation(jwrapper, planes)
    assert packed.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(packed, want)

    unpacked = football.unpackbits(torch.from_numpy(packed))
    assert unpacked.dtype == torch.float32 and unpacked.shape == (7, 5, 48)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jax_football.unpackbits(
            jnp.asarray(packed))))
    np.testing.assert_array_equal(unpacked[..., :35].numpy(),
                                  planes.astype(np.float32) * 255)
    np.testing.assert_array_equal(unpacked[..., 35:].numpy(), 0.0)


def test_football_create_environment_needs_gfootball():
    with pytest.raises(ImportError, match="gfootball"):
        football.create_environment()


def test_gfootball_net_on_packed_frames_matches_jax():
    B, H, W, C = 3, 24, 32, 2
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 2**16, (B, H, W, C)).astype(np.uint16)
    eo = dict(reward=np.zeros(B, np.float32), done=np.zeros(B, bool),
              observation=frames, abandoned=np.zeros(B, bool),
              episode_step=np.zeros(B, np.int32))
    prev = np.zeros(B, np.int32)
    jnet = jax_resnets.GFootball(parametric_distribution_param_size=19)
    jeo = JaxEnvOutput(**jax.tree.map(jnp.asarray, eo))
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(prev), jeo, ())
    (jlogits, jbaseline), _ = jnet.apply(params, jnp.asarray(prev), jeo, ())

    net = GFootball(19, observation_shape=(H, W, C), device="cpu")
    net.load_state_dict(convert.state_dict_for(
        net, jax.tree.map(np.asarray, params)), strict=True)
    teo = EnvOutput(**{k: torch.from_numpy(v) for k, v in eo.items()})
    with torch.no_grad():
        (logits, baseline), state = net(torch.from_numpy(prev), teo, ())
    assert state == () and net.initial_state(B) == ()
    assert logits.shape == (B, 19) and baseline.shape == (B,)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    np.testing.assert_allclose(baseline.numpy(), jbaseline, **TOL)


def test_atari_pool_and_resize_matches_jax():
    rng = np.random.RandomState(0)
    f0 = rng.randint(0, 255, (210, 160)).astype(np.uint8)
    f1 = rng.randint(0, 255, (210, 160)).astype(np.uint8)
    out = atari.pool_and_resize_frames(f0, f1, 84)
    assert out.shape == (84, 84, 1) and out.dtype == np.uint8
    assert out.tobytes() == jax_atari.pool_and_resize_frames(
        f0, f1, 84).tobytes()
    # The max pool comes before the resize: constant frames stay constant.
    const = atari.pool_and_resize_frames(np.full((210, 160), 10, np.uint8),
                                         np.full((210, 160), 200, np.uint8))
    np.testing.assert_array_equal(const, 200)


class _FakeAle:
    """A scripted ALE: screens from a seed, a life lost at step 5."""

    def __init__(self, env):
        self.env = env

    def lives(self):
        return 3 if self.env.t < 5 else 2

    def getScreenGrayscale(self, output):
        output[:] = (np.arange(output.size).reshape(output.shape)
                     * (self.env.t + 3)) % 251


class _FakeAtariEnv(gym.Env):
    observation_space = gym.spaces.Box(0, 255, (21, 16, 3), np.uint8)
    action_space = gym.spaces.Discrete(6)

    def __init__(self):
        self.t = 0
        self.ale = _FakeAle(self)

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros((21, 16, 3), np.uint8), {}

    def step(self, action):
        self.t += 1
        return (np.zeros((21, 16, 3), np.uint8), float(action + self.t),
                self.t >= 14, False, {})


@pytest.mark.parametrize("life_loss", [False, True])
def test_atari_preprocessing_matches_jax_step_for_step(life_loss):
    kw = dict(frame_skip=4, terminal_on_life_loss=life_loss, screen_size=12,
              max_random_noops=3)
    tenv = atari.AtariPreprocessing(_FakeAtariEnv(), **kw)
    jenv = jax_atari.AtariPreprocessing(_FakeAtariEnv(), **kw)
    assert tenv.observation_space.shape == jenv.observation_space.shape
    t_obs, _ = tenv.reset(seed=5)
    j_obs, _ = jenv.reset(seed=5)
    assert t_obs.tobytes() == j_obs.tobytes()
    for action in (1, 2, 0, 5, 3):
        got, want = tenv.step(action), jenv.step(action)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1:4] == want[1:4]
        if got[2]:
            break


def test_atari_create_environment_needs_ale_py():
    with pytest.raises(ImportError, match="ale_py"):
        atari.create_environment("Pong")


def test_dmlab_scores_and_registry_match_jax():
    assert dmlab.DMLAB_30 == jax_dmlab.DMLAB_30 and len(dmlab.DMLAB_30) == 30
    assert dmlab.HUMAN_SCORES == jax_dmlab.HUMAN_SCORES
    assert dmlab.RANDOM_SCORES == jax_dmlab.RANDOM_SCORES
    assert dmlab.DEFAULT_ACTION_SET == jax_dmlab.DEFAULT_ACTION_SET
    np.testing.assert_allclose(
        dmlab.human_normalized_score("rooms_watermaze", [54.0]), 100.0,
        rtol=1e-5)
    np.testing.assert_allclose(
        dmlab.human_normalized_score("rooms_watermaze", [4.065]), 0.0,
        atol=1e-5)
    for game in dmlab.HUMAN_SCORES:
        assert dmlab.human_normalized_score(game, [1.0, 7.5]) == (
            jax_dmlab.human_normalized_score(game, [1.0, 7.5]))
    with pytest.raises(ImportError, match="deepmind_lab"):
        dmlab.create_environment("rooms_watermaze")


def test_dmlab_level_cache(tmp_path):
    cache = dmlab.LevelCache(str(tmp_path / "cache"))
    pk3 = tmp_path / "level.pk3"
    pk3.write_bytes(b"compiled-level-bytes")
    out = tmp_path / "restored.pk3"
    assert not cache.fetch("seed:42:map1", str(out))
    cache.write("seed:42:map1", str(pk3))
    assert cache.fetch("seed:42:map1", str(out))
    assert out.read_bytes() == b"compiled-level-bytes"
    path = cache.get_path("seed:42:map1")
    assert path == jax_dmlab.LevelCache(str(tmp_path / "cache")).get_path(
        "seed:42:map1")
    head, tail = os.path.relpath(path, str(tmp_path / "cache")).split(os.sep)
    assert len(head) == 3 and len(head + tail) == 32
    cache.write("seed:42:map1", str(pk3))  # an existing key: a no-op


def test_synthetic_dmlab_env_shapes():
    env = BatchedEnv(SyntheticDmLabEnv(), 3, device="cpu")
    assert tuple(env.observation_spec().shape) == (72, 96, 3)
    assert env.action_space.n == 9
    state, out = env.reset()
    assert out.observation.shape == (3, 72, 96, 3)
    assert out.observation.dtype == torch.uint8
    state, out2 = env.step(state, torch.zeros(3, dtype=torch.int32))
    assert int((out2.observation != out.observation).sum()) > 0


@pytest.mark.parametrize("agent", ["vtrace", "ppo", "r2d2", "sac"])
@pytest.mark.parametrize("env,package", [("atari", "ale_py"),
                                         ("dmlab", "deepmind_lab"),
                                         ("football", "gfootball")])
def test_train_main_real_envs_need_their_packages(agent, env, package):
    if agent == "sac" and env == "football":
        with pytest.raises(ValueError, match="Football"):
            train.main([f"--agent={agent}", f"--env={env}", "--device=cpu"])
        return
    with pytest.raises(ImportError, match=package):
        train.main([f"--agent={agent}", f"--env={env}", "--device=cpu",
                    "--num_envs=2"])
