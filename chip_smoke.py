"""Smoke run of the receive chain on the GPU, through the user entry points.

    python chip_smoke.py             # one card: devices, main, parity
    python chip_smoke.py --chips 4   # four cards: sharded and fleet paths
                                     # against the single-card Receiver

Phases (any failure exits nonzero before the result line):

- devices: every JAX device is a GPU; prints the card's name and power
  limit as nvidia-smi reports them.
- main: ``Receiver.run`` at the flagship width (96 kHz IQ, 2048-point
  fft1, sellim, both blankers, fft2, mix1 -> fft3 -> mix2, SSB + AGC,
  256 fft1 frames = 262,144 samples per step) for ``MAIN_STEPS`` steps,
  then the weak-signal CW preset with AFC engaged.  Input is seeded
  ``io/siggen.py`` IQ: a weak keyed CW tone, a strong carrier, Gaussian
  noise and impulse noise, so that both blankers work.
- parity: the same Receiver on the CPU backend of this process, on the
  same input, against the GPU run's first ``PARITY_STEPS`` steps.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

MAIN_STEPS = 8
PARITY_STEPS = 4
SEED = 20261016
FLAGSHIP_FRAMES = 256          # fft1 frames per step
TUNE_HZ = 12_000.0             # an exact fftx bin at the flagship width
CW_HZ = 12_003.0

# GPU-vs-CPU relative error bound per output: max |gpu - cpu| over the
# compared steps divided by max |cpu|.  Both backends compute in
# float32; the chain's contractions are pinned to Precision.HIGHEST, so
# no TF32 rounding enters.  What differs is cuFFT against the CPU FFT
# and the order of reductions.
PARITY_TOL = {
    # window x FFT x calibration, then |X|^2 averaged over the frames:
    # linear, float32 transform rounding only (~1e-6 of the peak)
    "fft1_power": 1e-4,
    # after sellim, the weak/strong back transform, both blankers and a
    # second FFT: a pulse fit starts from an argmax over noisy power,
    # so rounding can move a subtraction by one sample
    "fft2_power": 1e-3,
    # mix1 -> fft3 -> mix2 baseband adds three more FFT stages on top
    "baseb": 2e-3,
    # AGC is a recursive gain; the error it carries stays within the
    # bound the earlier accelerator gate held (audio 2.3e-4 measured)
    "audio": 2e-3,
}

# Four-card paths against single-card receivers on the same IQ.
SHARDED_TOL = {
    # the power statistics are pmean-reduced over shards: summation order
    "fft1_power": 1e-4,
    # the clever blanker fits pulses shard-locally, so a pulse near a
    # shard boundary may be subtracted differently (the bound of
    # tests/test_sharded.py's blanker comparison).  Audio is not
    # compared here: the AGC turns such a residue into a gain change
    # over its 250 ms release (0.16 measured on four H100s);
    # SHARDED_LINEAR_TOL checks the audio path without the blanker.
    "baseb": 5e-2,
}
# the same with both blankers off: no shard-local decision is left, so
# the sharded chain answers as the single-card one up to reduction
# order, as in PARITY_TOL
SHARDED_LINEAR_TOL = {"fft1_power": 1e-4, "fft2_power": 1e-3,
                      "baseb": 2e-3, "audio": 2e-3}
FLEET_TOL = {
    # one vmapped program against separate programs: fusion and
    # reduction order only (as PARITY_TOL's narrowband outputs)
    "baseb": 2e-3,
    "audio": 2e-3,
}


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# ---- devices -------------------------------------------------------------

def require_gpus(devices, count: int = 1) -> None:
    """Refuse anything but ``count`` or more GPU devices."""
    plats = sorted({d.platform for d in devices})
    if plats != ["gpu"]:
        raise PhaseError(f"devices: need GPUs, JAX has {plats or 'none'}")
    if len(devices) < count:
        raise PhaseError(f"devices: need {count} GPUs, have {len(devices)}")


def card_info() -> str:
    """The cards' name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---- input ---------------------------------------------------------------

def flagship_params(tiny: bool = False):
    import __graft_entry__ as ge
    p = ge._flagship_params(tiny=tiny)
    return p if tiny else dataclasses.replace(
        p, target_fft1_frames_per_step=FLAGSHIP_FRAMES)


def wcw_params():
    from linrad_tpu import RxMode, preset
    return preset(RxMode.WCW)


def make_iq(fs: float, n: int, seed: int = SEED) -> np.ndarray:
    """(n, 1) complex64: weak keyed CW, strong carrier, Gaussian and
    impulse noise (seeded)."""
    from linrad_tpu.io.siggen import (Tone, gaussian_noise, impulse_noise,
                                      tones_iq)
    rng = np.random.default_rng(seed)
    iq = tones_iq(fs, n, [Tone(CW_HZ, amplitude=0.05, key_period_s=0.12,
                               key_duty=0.5),
                          Tone(-20_000.0, amplitude=1.0)])
    iq = (iq + gaussian_noise(rng, n, level_bits=-9)
          + impulse_noise(rng, n, rate_hz=40.0, fs=fs, amplitude=10.0))
    return iq.astype(np.complex64)[:, None]


# ---- running -------------------------------------------------------------

FIELDS = ("fft1_power", "fft2_power", "baseb", "audio")


@dataclasses.dataclass
class RunResult:
    step_seconds: list
    iq: np.ndarray                # the input the steps consumed
    samples_per_step: int
    outputs: list                 # host copies, one dict per step
    fitted: int                   # pulses the clever blanker subtracted
    cleared: int                  # points the stupid blanker cleared
    receiver: object

    @property
    def msps(self) -> float:
        """Steady rate: samples per step over the median step time after
        the first (compiling) step."""
        steady = sorted(self.step_seconds[1:]) or self.step_seconds
        return self.samples_per_step / steady[len(steady) // 2] / 1e6


def _host(out, fields=FIELDS) -> dict:
    return {f: np.asarray(getattr(out, f)) for f in fields
            if getattr(out, f) is not None}


def run_receiver(params, iq: np.ndarray, steps: int, device,
                 tune_hz: float = TUNE_HZ) -> RunResult:
    """``Receiver.run`` for ``steps`` steps with every array on
    ``device``; each step is timed to its outputs being ready."""
    import jax

    from linrad_tpu.pipeline import Receiver

    with jax.default_device(device):
        rx = Receiver(params)
        rx.tune(tune_hz)
        n = rx.geo.samples_per_step
        if iq.shape[0] < steps * n:
            raise PhaseError(f"input holds {iq.shape[0]} samples, "
                             f"{steps} steps need {steps * n}")
        times, kept, fitted, cleared = [], [], 0, 0
        t0 = time.perf_counter()
        for out in rx.run(iq[:steps * n]):
            jax.block_until_ready(out)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            kept.append(_host(out))
            if out.blanker_fitted is not None:
                fitted += int(out.blanker_fitted)
                cleared += int(out.blanker_cleared)
            t0 = time.perf_counter()
    if len(times) != steps:
        raise PhaseError(f"ran {len(times)} steps of {steps}")
    return RunResult(times, iq[:steps * n], n, kept, fitted, cleared, rx)


def check_outputs(res: RunResult, name: str) -> None:
    """Every step's outputs are finite and shaped as the geometry says."""
    g = res.receiver.geo
    want = {"fft1_power": (g.fft1_size, g.channels),
            "baseb": (g.baseband_samples_per_step, g.channels)}
    for i, out in enumerate(res.outputs):
        for f, a in out.items():
            if not np.all(np.isfinite(a)):
                raise PhaseError(f"{name}: step {i} {f} not finite")
            if f in want and a.shape != want[f]:
                raise PhaseError(f"{name}: {f} shape {a.shape}, "
                                 f"want {want[f]}")


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / max |ref| (ref all zero: max |got - ref|)."""
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    if got.shape != ref.shape:
        raise PhaseError(f"shape {got.shape} against {ref.shape}")
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    d = np.max(np.abs(got - ref)) if ref.size else 0.0
    return float(d / scale) if scale > 0 else float(d)


def compare(name: str, got: dict, ref: dict, tol: dict) -> dict:
    """Print each output's relative error beside its bound; raise if any
    is over (or not finite)."""
    errs, bad = {}, []
    for f, bound in tol.items():
        e = rel_err(got[f], ref[f])
        errs[f] = e
        ok = np.isfinite(e) and e <= bound
        say(f"  {name} {f}: rel err {e:.3e} (tol {bound:.0e})"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(f)
    if bad:
        raise PhaseError(f"{name}: over tolerance: {', '.join(bad)}")
    return errs


def stack_steps(outputs: list) -> dict:
    return {f: np.stack([o[f] for o in outputs]) for f in outputs[0]}


# ---- phases --------------------------------------------------------------

def phase_main(device, params=None, wcw=None, steps: int = MAIN_STEPS,
               seed: int = SEED):
    """Flagship Receiver, then the WCW preset with AFC; returns the
    flagship run, against which the parity phase compares."""
    params = params or flagship_params()
    wcw = wcw or wcw_params()
    from linrad_tpu import derive_geometry
    runs = {}
    for name, p in (("flagship", params), ("wcw+afc", wcw)):
        g = derive_geometry(p)
        iq = make_iq(g.rx_ad_speed, steps * g.samples_per_step, seed)
        res = run_receiver(p, iq, steps, device)
        check_outputs(res, name)
        say(f"main {name}: steps={steps} samples={steps * g.samples_per_step}"
            f" fft1={g.fft1_size} first_step_s={res.step_seconds[0]:.2f}"
            f" steady_msps={res.msps:.2f} blanker_fitted={res.fitted}"
            f" blanker_cleared={res.cleared} (informative, not a claim)")
        if p.blanker_enable and res.fitted + res.cleared == 0:
            raise PhaseError(f"main {name}: the blankers removed nothing")
        runs[name] = res
    afc = runs["wcw+afc"].receiver.afc
    if afc is None or afc.status not in (2, 3, 4):
        raise PhaseError("main wcw+afc: the AFC did not lock "
                         f"(status {None if afc is None else afc.status})")
    say(f"main wcw+afc: afc status={afc.status} "
        f"freq_hz={afc.freq_hz:.2f} (tone at {CW_HZ})")
    return runs["flagship"]


def phase_parity(ref_device, gpu_run: RunResult,
                 steps: int = PARITY_STEPS) -> dict:
    """The flagship Receiver on ``ref_device`` against the first
    ``steps`` steps of ``gpu_run``, on the same input."""
    ref = run_receiver(gpu_run.receiver.params, gpu_run.iq, steps,
                       ref_device)
    got = stack_steps(gpu_run.outputs[:steps])
    return compare("parity", got, stack_steps(ref.outputs), PARITY_TOL)


def phase_sharded(devices, steps: int = PARITY_STEPS, params=None,
                  seed: int = SEED) -> dict:
    """ShardedReceiver over ``devices`` against the single-card Receiver
    on ``devices[0]``, same IQ: the flagship, then the flagship with
    both blankers off."""
    import jax

    from linrad_tpu.parallel import ShardedReceiver

    d = len(devices)
    params = dataclasses.replace(params or flagship_params(), shards=d)
    linear = dataclasses.replace(params, blanker_enable=False)
    errs = {}
    for name, p, tol in ((f"sharded x{d}", params, SHARDED_TOL),
                         (f"sharded x{d} no blanker", linear,
                          SHARDED_LINEAR_TOL)):
        with jax.default_device(devices[0]):
            srx = ShardedReceiver(p, devices=list(devices))
            n = srx.geo.samples_per_step
            iq = make_iq(srx.geo.rx_ad_speed, steps * n, seed)
            srx.tune(TUNE_HZ)
            outs = [_host(o, tol) for o in srx.run(iq)]
        single = run_receiver(p, iq, steps, devices[0])
        errs[name] = compare(name, stack_steps(outs),
                             stack_steps(single.outputs), tol)
    return errs


def phase_fleet(devices, steps: int = PARITY_STEPS, params=None,
                seed: int = SEED) -> dict:
    """FleetRunner, one stream per device, against one single-card
    Receiver per stream (stream r on ``devices[r]``)."""
    from linrad_tpu.parallel import FleetRunner

    d = len(devices)
    params = params or flagship_params()
    fleet = FleetRunner(params, n_streams=d, k_steps=2,
                        outputs=tuple(FLEET_TOL), devices=list(devices))
    g = fleet.geo
    if steps % fleet.k:
        raise PhaseError(f"fleet: {steps} steps is not a multiple of "
                         f"k_steps={fleet.k}")
    n = steps * g.samples_per_step
    iqs = np.stack([make_iq(g.rx_ad_speed, n, seed + r) for r in range(d)])
    freqs = TUNE_HZ + 50.0 * np.arange(d)
    fleet.tune(freqs)
    got = fleet.process(iqs)
    errs = {}
    for r in range(d):
        res = run_receiver(params, iqs[r], steps, devices[r],
                           tune_hz=float(freqs[r]))
        ref = {f: np.concatenate([o[f] for o in res.outputs])
               for f in FLEET_TOL}
        errs[r] = compare(f"fleet stream {r}",
                          {f: got[f][r] for f in FLEET_TOL}, ref, FLEET_TOL)
    return errs


# ---- main ----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded and fleet comparisons")
    args = ap.parse_args(argv)

    # the parity phase needs JAX's CPU backend beside the GPU one
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    devices = jax.devices()
    require_gpus(devices, args.chips)
    from linrad_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    say(f"devices: {len(devices)} x {devices[0].device_kind}; "
        f"jax {jax.__version__}; compile cache {cache}")
    say(f"card: {card_info()}")

    if args.chips == 4:
        phase_sharded(devices[:4])
        phase_fleet(devices[:4])
    else:
        gpu_run = phase_main(devices[0])
        phase_parity(jax.devices("cpu")[0], gpu_run)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
