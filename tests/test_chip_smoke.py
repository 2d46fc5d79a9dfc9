"""chip_smoke.py's checks and phases, run on explicitly passed CPU devices
at a tiny geometry (the script itself refuses to run without a GPU)."""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from linrad_tpu import RxMode, preset  # noqa: E402


def _tiny():
    # fft1 256, but 65,536 samples a step: the blanker's 1 s noise-floor
    # tracker settles within the first step, as at the flagship width
    return dataclasses.replace(cs.flagship_params(tiny=True),
                               target_fft1_frames_per_step=512)


def _tiny_wcw():
    return preset(RxMode.WCW, fft1_n_override=9,
                  target_fft1_frames_per_step=256)


def _fake_devices(platform, n):
    return [types.SimpleNamespace(platform=platform, device_kind="x")] * n


class TestDeviceCheck:
    def test_refuses_cpu(self):
        with pytest.raises(cs.PhaseError, match="need GPUs"):
            cs.require_gpus(jax.devices("cpu"))

    def test_counts_gpus(self):
        cs.require_gpus(_fake_devices("gpu", 1))
        cs.require_gpus(_fake_devices("gpu", 4), count=4)
        with pytest.raises(cs.PhaseError, match="need 4 GPUs"):
            cs.require_gpus(_fake_devices("gpu", 1), count=4)
        with pytest.raises(cs.PhaseError):
            cs.require_gpus(_fake_devices("gpu", 1)
                            + _fake_devices("cpu", 1))

    def test_main_prints_no_result_on_cpu(self, capsys):
        with pytest.raises(cs.PhaseError):
            cs.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestComparator:
    @pytest.mark.parametrize("got,ref,want", [
        ([1.0, 2.0], [1.0, 2.0], 0.0),
        ([1.0, 2.5], [1.0, 2.0], 0.25),
        ([1j, 0.0], [0.0, 0.0], 1.0),          # zero reference: absolute
        ([3.0 + 4j], [0.0 + 0j], 5.0),
    ])
    def test_rel_err(self, got, ref, want):
        assert cs.rel_err(np.array(got), np.array(ref)) == \
            pytest.approx(want)

    def test_rel_err_shape_mismatch(self):
        with pytest.raises(cs.PhaseError, match="shape"):
            cs.rel_err(np.zeros(3), np.zeros(4))

    def test_compare_reports_each_bound(self, capsys):
        ref = {"a": np.ones(4), "b": np.ones(4)}
        got = {"a": np.ones(4) * (1 + 1e-6), "b": np.ones(4) * 1.5}
        errs = cs.compare("t", got, ref, {"a": 1e-5})
        assert errs["a"] == pytest.approx(1e-6)
        with pytest.raises(cs.PhaseError, match="b"):
            cs.compare("t", got, ref, {"a": 1e-5, "b": 0.1})
        out = capsys.readouterr().out
        assert "t a: rel err 1.000e-06 (tol 1e-05)" in out
        assert "FAIL" in out

    def test_compare_rejects_nan(self):
        with pytest.raises(cs.PhaseError):
            cs.compare("t", {"a": np.array([np.nan])},
                       {"a": np.array([1.0])}, {"a": 1.0})


class TestInput:
    def test_make_iq_seeded(self):
        a = cs.make_iq(96_000.0, 4096, seed=3)
        b = cs.make_iq(96_000.0, 4096, seed=3)
        c = cs.make_iq(96_000.0, 4096, seed=4)
        assert a.shape == (4096, 1) and a.dtype == np.complex64
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
        # impulse noise stands far above the Gaussian floor
        assert np.abs(a).max() > 5.0


class TestPhases:
    def test_main_then_parity(self):
        cpu = jax.devices("cpu")
        run = cs.phase_main(cpu[0], params=_tiny(), wcw=_tiny_wcw(),
                            steps=6)
        assert len(run.outputs) == 6 and run.fitted > 0
        errs = cs.phase_parity(cpu[1], run, steps=2)
        assert set(errs) == set(cs.PARITY_TOL)
        assert max(errs.values()) < 1e-5

    def test_sharded(self):
        errs = cs.phase_sharded(jax.devices("cpu")[:4], steps=2,
                                params=cs.flagship_params(tiny=True))
        assert set(errs["sharded x4"]) == set(cs.SHARDED_TOL)
        assert set(errs["sharded x4 no blanker"]) == \
            set(cs.SHARDED_LINEAR_TOL)

    def test_fleet(self):
        errs = cs.phase_fleet(jax.devices("cpu")[:4], steps=2,
                              params=cs.flagship_params(tiny=True))
        assert sorted(errs) == [0, 1, 2, 3]


def test_result_line_format(monkeypatch, capsys):
    """With a GPU the last line is the one JSON object the run reports."""
    gpus = _fake_devices("gpu", 1)
    monkeypatch.setattr(jax, "devices", lambda *a: gpus)
    monkeypatch.setattr(cs, "card_info", lambda: "H100, 700.00 W")
    monkeypatch.setattr(cs, "phase_main", lambda dev: None)
    monkeypatch.setattr(cs, "phase_parity", lambda dev, run: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent-cache")
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "H100, 700.00 W" in lines[-2]
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "x", "count": 1}}
