"""``chip_smoke.py`` on the CPU: each phase at tiny sizes, with the CPU
device standing in for the card (the kernel in the Pallas interpreter),
and the script's refusal to run without a GPU."""

from __future__ import annotations

import json

import jax
import pytest

import chip_smoke

CARD = "cpu stand-in"


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-cards"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


def test_phase_device_reports_platform(cpu, capsys):
    info = chip_smoke.phase_device(cpu, CARD)
    assert info == {
        "platform": "cpu",
        "kind": cpu.device_kind,
        "count": len(jax.devices()),
    }
    out = capsys.readouterr().out
    assert json.dumps(info) in out and f"card: {CARD}" in out


def test_phase_rollout_tiny(cpu, capsys):
    chip_smoke.phase_rollout(
        cpu, CARD, batch=16, horizon=650, rounds=2, check_batch=32,
        check_horizon=96, babyai_horizon=32, audit_batch=64,
    )
    out = capsys.readouterr().out
    assert "bit-equal" in out and '"ok": true' in out


def test_phase_dp_tiny(cpu, capsys):
    chip_smoke.phase_dp(
        cpu, CARD, d1_layouts=4, d1_sweeps=64, key_layouts=2,
        key_sweeps=48, bfs_layouts=2, interpret=True,
    )
    out = capsys.readouterr().out
    assert "equals BFS on 2 layouts" in out


def test_phase_ppo_tiny(cpu, capsys):
    chip_smoke.phase_ppo(
        cpu, CARD, num_envs=16, rollout_len=8, epochs=1, num_minibatches=2,
        updates=2, forward_batch=8,
    )
    out = capsys.readouterr().out
    assert "ppo update 2" in out and "agree with cpu" in out
