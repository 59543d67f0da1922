"""The port's launchers on the CPU: ``repro_torch.launch.train`` (save,
resume, the audio family refused) and ``repro_torch.launch.schedule``
against the reference's ``repro.launch.schedule.main()``, each in a
temporary working directory whose agent cache holds the golden agent of
``tests/golden`` (window 4): the same table, number for number."""
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as tck
from repro_torch.convert import DQN_KEYS, GOLDEN_WINDOW
from repro_torch.launch import schedule as tschedule, train as ttrain
from repro_torch.optim import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "train_agent_proxy_v1.npz"
TRAIN = ["--arch", "qwen2-moe-a2.7b", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
         "--device", "cpu"]


def test_train_saves_resumes_and_continues_as_one_run(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then a second run to 6 resumes at
    4 from the bf16 checkpoint; its state equals one uninterrupted 6-step
    run's bit for bit (the CPU is deterministic)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttrain.main(TRAIN + ["--steps", "4", "--ckpt-dir", a])
    first = capsys.readouterr().out.splitlines()
    assert first[0] == "arch=qwen2-moe-a2.7b-smoke device=cpu mesh=1x1 batch=2 seq=16"
    assert re.fullmatch(r"step    0 loss=[0-9.]+ \([0-9.]+ it/s\)", first[1])
    assert first[-1] == "done" and tck.committed_steps(a) == [2, 4]
    metrics = ttrain.main(TRAIN + ["--steps", "6", "--ckpt-dir", a])
    second = capsys.readouterr().out.splitlines()
    assert second[1] == "resumed @ 4" and second[-1] == "done"
    assert np.isfinite(metrics["loss"].item())
    ttrain.main(TRAIN + ["--steps", "6", "--ckpt-dir", b])
    resumed, _, _ = tck.restore(a, device="cpu")
    whole, _, step = tck.restore(b, device="cpu")
    assert step == 6 and resumed["params"]["emb"].dtype == torch.bfloat16
    for x, y in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ttrain.main(TRAIN + ["--steps", "6", "--ckpt-dir", a]) is None   # nothing left


def test_train_refuses_the_audio_family(tmp_path):
    with pytest.raises(NotImplementedError, match="frames"):
        ttrain.main(["--arch", "seamless-m4t-large-v2", "--steps", "1", "--device", "cpu"])


def test_schedule_matches_reference_on_the_golden_agent(tmp_path, monkeypatch, capsys):
    """Both launchers load the golden agent from the same cache (written by
    ``repro_torch.checkpoint``, as the reference's ``trained_agent`` writes
    one) and print the same five-method table with the oracle."""
    from repro.launch import schedule as jschedule

    episodes = 1500
    with np.load(GOLDEN) as z:
        params = {k: z[f"param_{i}"] for i, k in enumerate(DQN_KEYS)}
    monkeypatch.syspath_prepend(str(ROOT))            # the reference's benchmarks.common
    monkeypatch.chdir(tmp_path)
    tck.save(f"experiments/agents/w{GOLDEN_WINDOW}_c4_e{episodes}", episodes,
             {"params": params}, extra={"env_steps": 123}, keep_last=1)
    argv = ["--episodes", str(episodes), "--window", str(GOLDEN_WINDOW)]
    table = tschedule.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["schedule"] + argv)
    jschedule.main()
    ref = capsys.readouterr().out
    assert port == ref
    lines = port.splitlines()
    assert len(lines) == 7 and lines[0].split()[1:13] == [f"Q{i}" for i in range(1, 13)]
    assert list(table) == ["time_sharing", "mig_only", "mps_only", "mig_mps_default", "rl",
                           "oracle"]
    rl, oracle = np.array(table["rl"]), np.array(table["oracle"])
    assert (rl <= oracle + 1e-9).all() and np.allclose(table["time_sharing"], 1.0)
    agent, _ = tschedule.trained_agent(tschedule.get_zoo(), GOLDEN_WINDOW, episodes=episodes,
                                       device="cpu")
    assert agent.env_steps == 123
    for k in DQN_KEYS:
        assert np.array_equal(agent.params[k].numpy(), params[k])
