from seed_rl_torch.models.policy import (  # noqa: F401
    MLPAndLSTM,
    MLPPolicyNetwork,
)
