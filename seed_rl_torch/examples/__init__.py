"""Example ``--agent_module`` files for ``python -m seed_rl_torch.train``."""
