from seed_rl_torch.models.policy import (  # noqa: F401
    MLPAndLSTM,
    MLPPolicyNetwork,
)
from seed_rl_torch.models.dueling_mlp import VectorDuelingDQNNet  # noqa: F401
from seed_rl_torch.models.atari import (  # noqa: F401
    AgentState,
    AtariPolicyNet,
    DuelingLSTMDQNNet,
)
from seed_rl_torch.models.resnets import GFootball, ImpalaDeep  # noqa: F401
from seed_rl_torch.models.gtrxl import ImpalaGTrXL  # noqa: F401
from seed_rl_torch.models.sac_nets import (  # noqa: F401
    ActorCriticLSTM,
    ActorCriticMLP,
    VisualActorCritic,
)
