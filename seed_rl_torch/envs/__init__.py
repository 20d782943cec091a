from seed_rl_torch.envs.core import (  # noqa: F401
    BatchedEnv,
    BatchedEnvState,
    StepResult,
    TensorEnv,
    TensorSpec,
    TimeLimit,
)
from seed_rl_torch.envs.spaces import Box  # noqa: F401
from seed_rl_torch.envs.toy import ToyEnv, ToyMemoryEnv  # noqa: F401
