"""Atari environment adapter and the Nature-DQN preprocessing.

Port of ``seed_rl_tpu/envs/atari.py``, numpy only:
- ``AtariPreprocessing``: frame skip with a grayscale max pool over the
  last two raw frames, cv2 INTER_LINEAR resize to 84x84 uint8, random
  starting no-ops (1..max, before the frame skip), optional terminal on
  life loss. It follows the reference's Dopamine-derived implementation
  step for step: published Atari curves are defined relative to this exact
  pixel pipeline (the max pool before the resize, the uint8 round trip);
- ``pool_and_resize_frames``: the pool and resize as a function;
- ``create_environment``: ``{Game}NoFrameskip-{v0|v4}`` with the sticky
  actions switch and a 108,000-step (30 min) time limit.

``cv2``, ``ale_py`` and gymnasium are imported inside the functions that
need them; creating an env without ``ale_py`` raises a clear error.
"""

from typing import Optional

import numpy as np

from seed_rl_torch.envs.spaces import Box


class AtariPreprocessing:
    """Nature-DQN preprocessing over a raw NoFrameskip ALE env."""

    def __init__(
        self,
        environment,
        frame_skip: int = 4,
        terminal_on_life_loss: bool = False,
        screen_size: int = 84,
        max_random_noops: int = 0,
    ):
        if frame_skip <= 0 or screen_size <= 0:
            raise ValueError("frame_skip and screen_size must be positive")
        self.environment = environment
        self.terminal_on_life_loss = terminal_on_life_loss
        self.frame_skip = frame_skip
        self.screen_size = screen_size
        self.max_random_noops = max_random_noops

        obs_dims = self.environment.observation_space
        self.screen_buffer = [
            np.empty((obs_dims.shape[0], obs_dims.shape[1]), dtype=np.uint8),
            np.empty((obs_dims.shape[0], obs_dims.shape[1]), dtype=np.uint8),
        ]
        self.game_over = False
        self.lives = 0
        self._rng = np.random.RandomState()

    @property
    def observation_space(self):
        return Box(0, 255, (self.screen_size, self.screen_size, 1), np.uint8)

    @property
    def action_space(self):
        return self.environment.action_space

    def close(self):
        return self.environment.close()

    def _ale(self):
        return self.environment.unwrapped.ale

    def apply_random_noops(self):
        if self.max_random_noops <= 0:
            return
        # Always at least 1 no-op, matching other implementations.
        no_ops = self._rng.randint(1, self.max_random_noops + 1)
        for _ in range(no_ops):
            _, _, terminated, truncated, _ = self.environment.step(0)
            if terminated or truncated:
                self.environment.reset()

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.environment.reset(seed=seed)
        self.apply_random_noops()
        self.lives = self._ale().lives()
        self._fetch_grayscale_observation(self.screen_buffer[0])
        self.screen_buffer[1].fill(0)
        return self._pool_and_resize(), {}

    def step(self, action):
        accumulated_reward = 0.0
        is_terminal = False
        truncated = False
        info = {}
        for time_step in range(self.frame_skip):
            _, reward, terminated, truncated, info = self.environment.step(
                action
            )
            accumulated_reward += reward
            game_over = terminated or truncated

            if self.terminal_on_life_loss:
                new_lives = self._ale().lives()
                is_terminal = game_over or new_lives < self.lives
                self.lives = new_lives
            else:
                is_terminal = game_over

            if is_terminal:
                break
            elif time_step >= self.frame_skip - 2:
                t = time_step - (self.frame_skip - 2)
                self._fetch_grayscale_observation(self.screen_buffer[t])

        observation = self._pool_and_resize()
        self.game_over = is_terminal and not truncated
        return (
            observation,
            accumulated_reward,
            is_terminal and not truncated,
            truncated,
            info,
        )

    def _fetch_grayscale_observation(self, output):
        self._ale().getScreenGrayscale(output)
        return output

    def _pool_and_resize(self):
        import cv2

        if self.frame_skip > 1:
            np.maximum(
                self.screen_buffer[0],
                self.screen_buffer[1],
                out=self.screen_buffer[0],
            )
        transformed_image = cv2.resize(
            self.screen_buffer[0],
            (self.screen_size, self.screen_size),
            interpolation=cv2.INTER_LINEAR,
        )
        int_image = np.asarray(transformed_image, dtype=np.uint8)
        return np.expand_dims(int_image, axis=2)


def pool_and_resize_frames(
    frame0: np.ndarray, frame1: np.ndarray, screen_size: int = 84
) -> np.ndarray:
    """Pure function form of the pooling+resize step (for tests)."""
    import cv2

    pooled = np.maximum(frame0, frame1)
    resized = cv2.resize(
        pooled, (screen_size, screen_size), interpolation=cv2.INTER_LINEAR
    )
    return np.expand_dims(np.asarray(resized, np.uint8), axis=2)


def create_environment(
    game: str = "Pong",
    task: int = 0,
    sticky_actions: bool = False,
    num_action_repeats: int = 4,
    max_random_noops: int = 30,
):
    """``{Game}NoFrameskip-{v0|v4}``, 108k-step cap, full action space."""
    try:
        import ale_py
    except ImportError as e:
        raise ImportError(
            "Atari environments need ale_py (pip install ale-py "
            "gymnasium[atari]); preprocessing is testable without it via "
            "AtariPreprocessing/pool_and_resize_frames."
        ) from e
    import gymnasium as gym

    gym.register_envs(ale_py)
    game_version = "v0" if sticky_actions else "v4"
    full_game_name = f"{game}NoFrameskip-{game_version}"
    env = gym.make(full_game_name, full_action_space=True)
    env = gym.wrappers.TimeLimit(env.unwrapped, max_episode_steps=108000)
    env.reset(seed=task)
    return AtariPreprocessing(
        env,
        frame_skip=num_action_repeats,
        max_random_noops=max_random_noops,
    )
