"""chip_smoke.py: refuses to run without a GPU, and its phases rehearse
on the CPU at tiny widths (the GPU run itself is `python chip_smoke.py`,
which needs the card)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert "kaldi_tpu is not importable" in out.stderr
    assert '"ok"' not in out.stdout


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_devices_option_accepts_only_one_or_four():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--devices", "2"])


def test_single_card_phases_rehearse_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    chip_smoke.run_single(chip_smoke.TINY, cpu, "cpu")
    out = capsys.readouterr().out
    for tag in ("[2] f32 log-posteriors", "[3] train step", "[4] slice",
                "[5] lattices", "[6] streaming"):
        assert tag in out


def test_four_device_phase_rehearses_on_cpu(capsys):
    chip_smoke.run_multi(chip_smoke.TINY, jax.devices()[:4])
    out = capsys.readouterr().out
    assert "[dp]" in out and out.count("[sharded]") == 3


def test_four_device_phase_runs_every_part_and_fails_at_the_end(
        monkeypatch, capsys):
    real = chip_smoke.same_hyps

    def flaky(a, b, what, **kw):
        if what.startswith("decode_sharded"):
            raise chip_smoke.SmokeFailure("injected")
        return real(a, b, what, **kw)

    monkeypatch.setattr(chip_smoke, "same_hyps", flaky)
    with pytest.raises(chip_smoke.SmokeFailure, match="injected"):
        chip_smoke.run_multi(chip_smoke.TINY, jax.devices()[:4])
    out = capsys.readouterr().out
    assert "decode_frontier_sharded 1 x" in out
    assert "FusedStreamingServer 4 streams" in out


def test_check_raises_smoke_failure():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")
    chip_smoke.check(True, "never")
