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
from seed_rl_torch.envs.host import (  # noqa: F401
    DiscretizeEnvWrapper,
    HostBatchedEnv,
    UniformBoundActionSpaceWrapper,
)
from seed_rl_torch.envs.spaces import (  # noqa: F401
    Box,
    Discrete,
    MultiDiscrete,
)
from seed_rl_torch.envs.synthetic import (  # noqa: F401
    SyntheticAtariEnv,
    SyntheticAtariGymEnv,
    SyntheticDmLabEnv,
    SyntheticFootballEnv,
)
from seed_rl_torch.envs.toy import (  # noqa: F401
    BitFlippingEnv,
    DiscreteMatchEnv,
    ToyEnv,
    ToyMemoryEnv,
)
