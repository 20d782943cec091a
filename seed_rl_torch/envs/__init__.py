from seed_rl_torch.envs.core import (  # noqa: F401
    BatchedEnv,
    BatchedEnvState,
    StepResult,
    TensorEnv,
    TensorSpec,
    TimeLimit,
)
from seed_rl_torch.envs.catch import (  # noqa: F401
    CatchEnv,
    ContinuousCatchEnv,
)
from seed_rl_torch.envs.spaces import Box, Discrete  # noqa: F401
from seed_rl_torch.envs.synthetic import (  # noqa: F401
    SyntheticAtariEnv,
    SyntheticDmLabEnv,
)
from seed_rl_torch.envs.toy import (  # noqa: F401
    BitFlippingEnv,
    DiscreteMatchEnv,
    ToyEnv,
    ToyMemoryEnv,
)
