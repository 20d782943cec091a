"""The port's R2D2 replay soak harness (``python -m
seed_rl_torch.tools.soak_r2d2_replay``), as tests/test_host_offpolicy.py
runs the JAX package's ``scripts/soak_r2d2_replay.py``.

At toy scale on the CPU every run: 500 unrolls of 121 x 84x84 uint8
frames in the host-RAM replay, a 64-unit LSTM, 5 s of the sustained
insert / prioritized sample with the prefetch thread / train / priority
write-back cycle at replay ratio 0.75. The full 100k-unroll (~86 GiB) soak
is opt-in:

    SEED_RL_TORCH_SOAK=1 pytest tests/test_torch_soak.py
or  python -m seed_rl_torch.tools.soak_r2d2_replay
"""

import math
import os

import torch

from seed_rl_torch.tools import soak_r2d2_replay


def test_r2d2_replay_soak_harness(capsys):
    full = os.environ.get("SEED_RL_TORCH_SOAK") == "1"
    args = (["--seconds=60"] if full else
            ["--device=cpu", "--buffer_size=500", "--seconds=5",
             "--lstm_size=64"])
    threads = torch.get_num_threads()
    if not full:
        torch.set_num_threads(1)
    try:
        result = soak_r2d2_replay.main(args)
    finally:
        torch.set_num_threads(threads)
    assert result["buffer_unrolls"] == (100_000 if full else 500)
    assert result["train_batches"] >= 1
    assert result["sustained_env_frames_per_sec"] > 0
    assert result["train_batches_per_sec"] > 0
    assert all(math.isfinite(v) and v > 0
               for v in result["stage_ms"].values())
    # 500 items of 121 x 84 x 84 bytes of frames, and their other leaves.
    assert result["buffer_gib"] > 500 * 121 * 84 * 84 / 2 ** 30
    # The last line of stdout is the JSON line.
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"metric": "r2d2_host_replay_soak"')
    if full:
        assert result["buffer_gib"] > 80  # the reference's scale
