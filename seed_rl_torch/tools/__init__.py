"""Operational tools of seed_rl_torch (``python -m seed_rl_torch.tools.X``)."""
