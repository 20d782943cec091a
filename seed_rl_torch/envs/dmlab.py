"""DeepMind Lab adapter, the DMLab-30 task registry and score anchors.

Port of ``seed_rl_tpu/envs/dmlab.py``, numpy only:
- ``DmLab``: a wrapper with gymnasium's API over the deepmind_lab API,
  with the standard 9-action discrete set; it needs the ``deepmind_lab``
  package, imported when one is made;
- the DMLab-30 level registry, the published human and random score
  anchors (the IMPALA paper's evaluation constants, as data) and the
  human-normalized score;
- ``LevelCache``: the compiled-level cache for procedurally generated maps.
"""

from typing import Dict, Optional

import numpy as np

from seed_rl_torch.envs.spaces import Box, Discrete

# The standard 9-action discrete set (dmlab/env.py:44-54):
# (look_left, look_right, strafe_left, strafe_right, forward, backward,
#  forward+look_left, forward+look_right, fire).
DEFAULT_ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),  # Forward
    (0, 0, 0, -1, 0, 0, 0),  # Backward
    (0, 0, -1, 0, 0, 0, 0),  # Strafe Left
    (0, 0, 1, 0, 0, 0, 0),  # Strafe Right
    (-20, 0, 0, 0, 0, 0, 0),  # Look Left
    (20, 0, 0, 0, 0, 0, 0),  # Look Right
    (-20, 0, 0, 1, 0, 0, 0),  # Look Left + Forward
    (20, 0, 0, 1, 0, 0, 0),  # Look Right + Forward
    (0, 0, 0, 0, 1, 0, 0),  # Fire
)

DMLAB_30 = (
    "rooms_collect_good_objects_train",
    "rooms_exploit_deferred_effects_train",
    "rooms_select_nonmatching_object",
    "rooms_watermaze",
    "rooms_keys_doors_puzzle",
    "language_select_described_object",
    "language_select_located_object",
    "language_execute_random_task",
    "language_answer_quantitative_question",
    "lasertag_one_opponent_small",
    "lasertag_three_opponents_small",
    "lasertag_one_opponent_large",
    "lasertag_three_opponents_large",
    "natlab_fixed_large_map",
    "natlab_varying_map_regrowth",
    "natlab_varying_map_randomized",
    "skymaze_irreversible_path_hard",
    "skymaze_irreversible_path_varied",
    "psychlab_arbitrary_visuomotor_mapping",
    "psychlab_continuous_recognition",
    "psychlab_sequential_comparison",
    "psychlab_visual_search",
    "explore_object_locations_small",
    "explore_object_locations_large",
    "explore_obstructed_goals_small",
    "explore_obstructed_goals_large",
    "explore_goal_locations_small",
    "explore_goal_locations_large",
    "explore_object_rewards_few",
    "explore_object_rewards_many",
)

# Published human/random evaluation anchors (IMPALA paper; reference
# dmlab/games.py:58-122). Keys use the *_test variants where the reference
# does.
HUMAN_SCORES: Dict[str, float] = {
    "rooms_collect_good_objects_test": 10,
    "rooms_exploit_deferred_effects_test": 85.65,
    "rooms_select_nonmatching_object": 65.9,
    "rooms_watermaze": 54,
    "rooms_keys_doors_puzzle": 53.8,
    "language_select_described_object": 389.5,
    "language_select_located_object": 280.7,
    "language_execute_random_task": 254.05,
    "language_answer_quantitative_question": 184.5,
    "lasertag_one_opponent_small": 12.65,
    "lasertag_three_opponents_small": 18.55,
    "lasertag_one_opponent_large": 18.6,
    "lasertag_three_opponents_large": 31.5,
    "natlab_fixed_large_map": 36.9,
    "natlab_varying_map_regrowth": 24.45,
    "natlab_varying_map_randomized": 42.35,
    "skymaze_irreversible_path_hard": 100,
    "skymaze_irreversible_path_varied": 100,
    "psychlab_arbitrary_visuomotor_mapping": 58.75,
    "psychlab_continuous_recognition": 58.3,
    "psychlab_sequential_comparison": 39.5,
    "psychlab_visual_search": 78.5,
    "explore_object_locations_small": 74.45,
    "explore_object_locations_large": 65.65,
    "explore_obstructed_goals_small": 206,
    "explore_obstructed_goals_large": 119.5,
    "explore_goal_locations_small": 267.5,
    "explore_goal_locations_large": 194.5,
    "explore_object_rewards_few": 77.7,
    "explore_object_rewards_many": 106.7,
}

RANDOM_SCORES: Dict[str, float] = {
    "rooms_collect_good_objects_test": 0.073,
    "rooms_exploit_deferred_effects_test": 8.501,
    "rooms_select_nonmatching_object": 0.312,
    "rooms_watermaze": 4.065,
    "rooms_keys_doors_puzzle": 4.135,
    "language_select_described_object": -0.07,
    "language_select_located_object": 1.929,
    "language_execute_random_task": -5.913,
    "language_answer_quantitative_question": -0.33,
    "lasertag_one_opponent_small": -0.224,
    "lasertag_three_opponents_small": -0.214,
    "lasertag_one_opponent_large": -0.083,
    "lasertag_three_opponents_large": -0.102,
    "natlab_fixed_large_map": 2.173,
    "natlab_varying_map_regrowth": 2.989,
    "natlab_varying_map_randomized": 7.346,
    "skymaze_irreversible_path_hard": 0.1,
    "skymaze_irreversible_path_varied": 14.4,
    "psychlab_arbitrary_visuomotor_mapping": 0.163,
    "psychlab_continuous_recognition": 0.224,
    "psychlab_sequential_comparison": 0.129,
    "psychlab_visual_search": 0.085,
    "explore_object_locations_small": 3.575,
    "explore_object_locations_large": 4.673,
    "explore_obstructed_goals_small": 6.76,
    "explore_obstructed_goals_large": 2.61,
    "explore_goal_locations_small": 7.66,
    "explore_goal_locations_large": 3.14,
    "explore_object_rewards_few": 2.073,
    "explore_object_rewards_many": 2.438,
}


def human_normalized_score(game: str, returns) -> float:
    """(mean(returns) - random) / (human - random) * 100."""
    human = HUMAN_SCORES[game]
    random = RANDOM_SCORES[game]
    return float((np.mean(returns) - random) / (human - random) * 100.0)


class LevelCache:
    """Compiled-level cache for procedurally generated DmLab maps.

    Same contract as the reference (dmlab/env.py:57-80): deepmind_lab calls
    ``fetch(key, pk3_path)`` before compiling a level (return True if the
    cached .pk3 was copied into place) and ``write(key, pk3_path)`` after
    compiling a new one. Keys are md5-hashed and fanned out into 3-hex-char
    subdirectories. Works on any mounted filesystem path (local disk, NFS,
    GCS via gcsfuse) — no TF gfile dependency.
    """

    def __init__(self, cache_dir: str):
        self._cache_dir = cache_dir

    def get_path(self, key: str) -> str:
        import hashlib
        import os

        digest = hashlib.md5(key.encode("utf-8")).hexdigest()
        return os.path.join(self._cache_dir, digest[:3], digest[3:])

    def fetch(self, key: str, pk3_path: str) -> bool:
        import shutil

        try:
            shutil.copyfile(self.get_path(key), pk3_path)
            return True
        except OSError:
            return False

    def write(self, key: str, pk3_path: str) -> None:
        import os
        import shutil

        path = self.get_path(key)
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # Copy via a temp name so concurrent actors never see a
            # partially written cache entry.
            tmp = path + ".tmp%d" % os.getpid()
            shutil.copyfile(pk3_path, tmp)
            os.replace(tmp, path)


class DmLab:
    """A wrapper with gymnasium's API over a deepmind_lab environment."""

    def __init__(
        self,
        game: str,
        seed: int = 0,
        width: int = 96,
        height: int = 72,
        action_set=DEFAULT_ACTION_SET,
        num_action_repeats: int = 4,
        level_cache=None,
        is_test: bool = False,
        extra_config: Optional[Dict[str, str]] = None,
    ):
        try:
            import deepmind_lab
        except ImportError as e:
            raise ImportError(
                "DmLab environments need the deepmind_lab package; the "
                "DMLab-30 registry, scores and ImpalaDeep network are usable "
                "without it."
            ) from e

        if game in DMLAB_30 or game in HUMAN_SCORES:
            game = "contributed/dmlab30/" + game
        config = {
            "width": width,
            "height": height,
            "logLevel": "WARN",
        }
        if is_test:
            # Held-out evaluation levels + the fixed mixer seed the DmLab
            # docs prescribe for evaluation (reference env.py:90-94).
            config["allowHoldOutLevels"] = "true"
            config["mixerSeed"] = 0x600D5EED
        if extra_config:
            config.update(extra_config)
        self._env = deepmind_lab.Lab(
            game,
            ["RGB_INTERLEAVED"],
            config={k: str(v) for k, v in config.items()},
            level_cache=level_cache,
        )
        self._action_set = action_set
        self._num_action_repeats = num_action_repeats
        # Per-episode reseeding stream (reference env.py:101,120-122):
        # every reset draws a fresh int31 from a seed-keyed RandomState so
        # episodes differ while runs stay reproducible per (task) seed.
        self._random_state = np.random.RandomState(seed=seed)
        self.observation_space = Box(0, 255, (height, width, 3), np.uint8)
        self.action_space = Discrete(len(action_set))

    def _observation(self):
        return self._env.observations()["RGB_INTERLEAVED"]

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._random_state = np.random.RandomState(seed=seed)
        self._env.reset(seed=self._random_state.randint(0, 2**31 - 1))
        return self._observation(), {}

    def step(self, action):
        raw_action = np.array(self._action_set[action], np.intc)
        reward = self._env.step(
            raw_action, num_steps=self._num_action_repeats
        )
        terminated = not self._env.is_running()
        if terminated:
            self._env.reset(
                seed=self._random_state.randint(0, 2**31 - 1)
            )
        return self._observation(), reward, terminated, False, {}

    def close(self):
        self._env.close()


def create_environment(game: str, task: int = 0, **kwargs):
    return DmLab(game, seed=task, **kwargs)
