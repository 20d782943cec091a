"""seed_rl_torch: the PyTorch/CUDA port of seed_rl_tpu for NVIDIA Hopper.

The package mirrors ``seed_rl_tpu``'s layout module by module, so each port
sits at the same path as its JAX reference. It imports no JAX and nothing of
``seed_rl_tpu``; the tests hold the two packages against each other.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"`` or ``--device=cpu``); see ``seed_rl_torch.device``.
"""
