"""Catch: a visual-control environment that runs entirely on the device.

Port of ``seed_rl_tpu/envs/catch.py``. A ball falls one row per step from
a random column, a paddle on the bottom row moves left/stay/right, and the
agent is rewarded +1/-1 when the ball lands on/off the paddle, so the
policy must read the pixels to act. Grid ``rows x cols`` cells are
rendered as ``cell_pixels``-square blocks into a ``[rows*cell, cols*cell,
1]`` uint8 frame (the defaults give 84x84, the Atari shape). An episode is
``balls_per_episode`` drops. ``ContinuousCatchEnv`` is SAC's variant: a
continuous paddle velocity, the same episodes, spawns and frames.

The state is ``[B]`` int32 tensors. Where the JAX package carries a PRNG
key per env, each step here draws a candidate column for every env from
the ``BatchedEnv`` generator and keeps it where the ball landed; the
dynamics match the JAX package given the same columns.
"""

from typing import NamedTuple

import torch

from seed_rl_torch.envs.core import StepResult, TensorEnv, TensorSpec
from seed_rl_torch.envs.spaces import Box, Discrete
from seed_rl_torch.parallel import draws


class CatchState(NamedTuple):
    ball_row: torch.Tensor  # i32[B] 0 = top
    ball_col: torch.Tensor  # i32[B]
    paddle_col: torch.Tensor  # i32[B]
    balls_done: torch.Tensor  # i32[B] balls resolved this episode


class CatchEnv(TensorEnv):
    """bsuite-style Catch at Atari frame scale, on the device."""

    def __init__(
        self,
        rows: int = 12,
        cols: int = 12,
        cell_pixels: int = 7,
        balls_per_episode: int = 5,
    ):
        self.rows = rows
        self.cols = cols
        self.cell_pixels = cell_pixels
        self.balls_per_episode = balls_per_episode
        self.num_actions = 3  # left, stay, right
        self._action_space = Discrete(3)

    def observation_spec(self):
        return TensorSpec(
            (self.rows * self.cell_pixels, self.cols * self.cell_pixels, 1),
            torch.uint8,
        )

    @property
    def action_space(self):
        return self._action_space

    def _obs(self, state: CatchState):
        device = state.ball_row.device
        row = torch.arange(self.rows, dtype=torch.int32, device=device)
        col = torch.arange(self.cols, dtype=torch.int32, device=device)
        row, col = row[None, :, None], col[None, None, :]
        ball = ((row == state.ball_row[:, None, None])
                & (col == state.ball_col[:, None, None]))
        paddle = (row == self.rows - 1) & (col == state.paddle_col[:, None,
                                                                    None])
        grid = (ball | paddle).to(torch.uint8) * 255  # [B, rows, cols]
        frame = grid.repeat_interleave(self.cell_pixels, dim=1)
        frame = frame.repeat_interleave(self.cell_pixels, dim=2)
        return frame[..., None]

    def _spawn(self, num_envs, generator):
        return draws.randint(0, self.cols, (num_envs,), generator,
                             device=generator.device, dtype=torch.int32)

    def reset(self, num_envs, generator):
        zeros = torch.zeros(num_envs, dtype=torch.int32,
                            device=generator.device)
        state = CatchState(
            ball_row=zeros,
            ball_col=self._spawn(num_envs, generator),
            paddle_col=torch.full_like(zeros, self.cols // 2),
            balls_done=zeros,
        )
        return state, self._obs(state)

    def step(self, state: CatchState, action, generator):
        # action: 0 = left, 1 = stay, 2 = right.
        paddle_col = torch.clamp(
            state.paddle_col + action.to(torch.int32) - 1, 0, self.cols - 1)
        ball_row = state.ball_row + 1
        landed = ball_row >= self.rows - 1
        caught = landed & (state.ball_col == paddle_col)
        reward = torch.where(
            landed, caught.to(torch.float32) * 2.0 - 1.0,
            torch.zeros_like(paddle_col, dtype=torch.float32))
        balls_done = state.balls_done + landed.to(torch.int32)
        terminated = balls_done >= self.balls_per_episode

        # Next ball (only materializes where the current one landed).
        new_col = self._spawn(ball_row.shape[0], generator)
        new_state = CatchState(
            ball_row=torch.where(landed, torch.zeros_like(ball_row),
                                 ball_row),
            ball_col=torch.where(landed, new_col, state.ball_col),
            paddle_col=paddle_col,
            balls_done=balls_done,
        )
        return StepResult(
            state=new_state,
            observation=self._obs(new_state),
            reward=reward,
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )


class ContinuousCatchState(NamedTuple):
    ball_row: torch.Tensor  # i32[B]
    ball_col: torch.Tensor  # i32[B]
    paddle_pos: torch.Tensor  # f32[B] in [0, cols-1]
    balls_done: torch.Tensor  # i32[B]


class ContinuousCatchEnv(CatchEnv):
    """Catch with a continuous paddle-velocity action (SAC's variant).

    The action is a ``Box(-1, 1, (1,))`` velocity; the paddle is a float
    position moving up to ``max_speed`` cells a step, rendered at its
    rounded cell, and a ball is caught when the paddle is within
    ``catch_radius`` cells of its column at landing. Episodes and spawn
    draws are ``CatchEnv``'s.
    """

    def __init__(
        self,
        rows: int = 12,
        cols: int = 12,
        cell_pixels: int = 7,
        balls_per_episode: int = 5,
        max_speed: float = 1.5,
        catch_radius: float = 0.75,
    ):
        super().__init__(rows, cols, cell_pixels, balls_per_episode)
        self.max_speed = max_speed
        self.catch_radius = catch_radius
        self._action_space = Box(-1.0, 1.0, (1,))

    def _obs_continuous(self, state: ContinuousCatchState):
        # Round half to even, as jnp.round does.
        cell = torch.round(state.paddle_pos).to(torch.int32)
        return self._obs(CatchState(
            ball_row=state.ball_row,
            ball_col=state.ball_col,
            paddle_col=torch.clamp(cell, 0, self.cols - 1),
            balls_done=state.balls_done,
        ))

    def reset(self, num_envs, generator):
        zeros = torch.zeros(num_envs, dtype=torch.int32,
                            device=generator.device)
        state = ContinuousCatchState(
            ball_row=zeros,
            ball_col=self._spawn(num_envs, generator),
            paddle_pos=torch.full((num_envs,), (self.cols - 1) / 2.0,
                                  dtype=torch.float32,
                                  device=generator.device),
            balls_done=zeros,
        )
        return state, self._obs_continuous(state)

    def step(self, state: ContinuousCatchState, action, generator):
        velocity = torch.clamp(
            action.to(torch.float32).reshape(state.paddle_pos.shape), -1.0,
            1.0)
        paddle_pos = torch.clamp(state.paddle_pos + velocity * self.max_speed,
                                 0.0, float(self.cols - 1))
        ball_row = state.ball_row + 1
        landed = ball_row >= self.rows - 1
        caught = landed & (torch.abs(state.ball_col.to(torch.float32)
                                     - paddle_pos) <= self.catch_radius)
        reward = torch.where(landed, caught.to(torch.float32) * 2.0 - 1.0,
                             torch.zeros_like(paddle_pos))
        balls_done = state.balls_done + landed.to(torch.int32)
        terminated = balls_done >= self.balls_per_episode
        new_col = self._spawn(ball_row.shape[0], generator)
        new_state = ContinuousCatchState(
            ball_row=torch.where(landed, torch.zeros_like(ball_row),
                                 ball_row),
            ball_col=torch.where(landed, new_col, state.ball_col),
            paddle_pos=paddle_pos,
            balls_done=balls_done,
        )
        return StepResult(
            state=new_state,
            observation=self._obs_continuous(new_state),
            reward=reward,
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )
