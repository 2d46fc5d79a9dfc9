"""Synchronized radar mode: TX/RX round trip on a synthetic echo.

Validates the JAX run_radar (linrad_tpu/weak/radar.py vs
reference radar.c:121-520): the tracker must identify the transmitted
pulse train from the fft1 power stream alone (separation, frequency
bin), then accumulate a range display in which the synthetic echo
appears at the correct delay after the TX pulse.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from linrad_tpu.geometry import derive_geometry
from linrad_tpu.ops.fft1 import FFT1State, FFT1Tables, fft1_step
from linrad_tpu.params import RxParams
from linrad_tpu.tx.keying import radar_pulse_train
from linrad_tpu.weak.radar import RadarParams, RadarTracker, frame_pulse_stats


FS = 96_000
PULSE_SEP_FRAMES = 40          # transforms between TX pulses
PULSE_WIDTH_FRAMES = 3
ECHO_DELAY_FRAMES = 8
TX_BIN = 100                   # carrier at bin 100 = 9375 Hz


def _geometry():
    p = RxParams(first_fft_bandwidth=200.0, target_fft1_frames_per_step=32)
    return derive_geometry(p), p


def _radar_iq(geo, n_steps: int, echo_amp: float = 0.05,
              noise: float = 1e-3, seed: int = 7) -> np.ndarray:
    """TX leak-through + delayed echo + receive noise, with the RX
    front end muted during transmit (the radar operating condition
    radar.c:186-193 relies on)."""
    stride = geo.fft1_new_points
    n = n_steps * geo.samples_per_step
    period = PULSE_SEP_FRAMES * stride
    width = PULSE_WIDTH_FRAMES * stride
    delay = ECHO_DELAY_FRAMES * stride
    rng = np.random.default_rng(seed)

    env = radar_pulse_train(FS, FS / period, width / FS, n / FS,
                            rise_s=0.0002)[:n]
    t = np.arange(n)
    carrier = np.exp(2j * np.pi * TX_BIN / geo.fft1_size * t)
    tx = env * carrier
    echo = np.zeros(n, np.complex128)
    echo[delay:] = echo_amp * tx[:-delay]
    nz = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    nz *= np.where(env > 0.01, 0.01, 1.0)      # RX muted during TX
    return (tx + echo + nz).astype(np.complex64)


def test_frame_pulse_stats_flags_pulse_frames():
    rng = np.random.default_rng(0)
    pw = rng.random((16, 256)).astype(np.float32)
    pw[5, 60] = 5000.0
    k, ston, floor = (np.asarray(a) for a in
                      frame_pulse_stats(jnp.asarray(pw)))
    assert k[5] == 60
    assert ston[5] > 100 * np.median(ston)
    assert abs(floor[5] - 0.5) < 0.1


def test_radar_round_trip_lock_and_range():
    geo, p = _geometry()
    n_steps = 26                        # 832 frames ≈ 20 pulses
    iq = _radar_iq(geo, n_steps)

    tables = FFT1Tables.create(geo, edge_taper=False)
    state = FFT1State.create(geo)
    tracker = RadarTracker(
        n_bins=geo.fft1_size,
        frame_time_s=geo.fft1_new_points / FS,
        params=RadarParams(time=2.0, lock_after=500))

    for s in range(n_steps):
        blk = jnp.asarray(
            iq[s * geo.samples_per_step:(s + 1) * geo.samples_per_step,
               None])
        state, spec, _ = fft1_step(geo, tables, state, blk, avg1num=64)
        power = np.abs(np.asarray(spec)) ** 2
        tracker.feed(power)

    # pulse-train identification (run_radar radar.c:227-345)
    assert tracker.locked
    assert tracker.pulse_sep == PULSE_SEP_FRAMES
    assert tracker.pulse_bin == TX_BIN
    assert tracker.lines == PULSE_SEP_FRAMES + 20
    assert tracker.update_cnt >= 8

    # range display: TX pulse then echo ECHO_DELAY_FRAMES lines later
    prof = tracker.range_profile()
    assert len(prof) == tracker.lines
    # the window spans pulse_sep+20 lines so it contains the *next* TX
    # pulse as well (as the reference display does); anchor on the first
    # strong line = this pulse
    tx_line = int(np.argmax(prof > 0.5 * prof.max()))
    assert tx_line < 14                 # 10-transform backup + smear
    # mask both TX pulses and their skirts; the next peak is the echo
    masked = prof.copy()
    for p0 in (tx_line, tx_line + PULSE_SEP_FRAMES):
        lo = max(p0 - PULSE_WIDTH_FRAMES - 2, 0)
        masked[lo: p0 + PULSE_WIDTH_FRAMES + 3] = 0.0
    echo_line = int(np.argmax(masked))
    assert abs((echo_line - tx_line) - ECHO_DELAY_FRAMES) <= 1
    # echo is far above the noise floor of the display
    floor = np.median(masked[masked > 0]) if np.any(masked > 0) else 0.0
    assert masked[echo_line] > 10 * floor

    # range conversion: line offset -> metres (c * t / 2)
    rng_m = tracker.line_to_range_m(echo_line - tx_line)
    expect = 299_792_458.0 * ECHO_DELAY_FRAMES * geo.fft1_new_points \
        / FS / 2.0
    assert abs(rng_m - expect) / expect < 0.2

    img = tracker.display_image()
    assert img.shape == tracker.average.shape
    assert np.all((img >= 0) & (img <= 1))


def test_radar_no_lock_without_pulses():
    geo, _ = _geometry()
    rng = np.random.default_rng(3)
    tracker = RadarTracker(
        n_bins=geo.fft1_size, frame_time_s=geo.fft1_new_points / FS,
        params=RadarParams(lock_after=100))
    for _ in range(6):
        pw = rng.random((32, geo.fft1_size)).astype(np.float32)
        tracker.feed(pw)
    assert not tracker.locked


def test_radar_graph_image():
    from linrad_tpu.viz import radar_graph_image

    class T:
        average = np.array([[1.0, 100.0], [0.01, 1e-9]], np.float32)

    img = radar_graph_image(T())
    assert img.shape == (2, 2)
    assert img[0, 1] == 1.0 and img[1, 1] == 0.0
    assert np.all((img >= 0) & (img <= 1))

    class Empty:
        average = np.zeros((0, 0), np.float32)

    assert radar_graph_image(Empty()).shape == (0, 0)


def test_radar_history_stays_bounded():
    """Long-running session: the host-side frame history must stay
    bounded (the fft1_sumsq ring analog) — scanning must advance past
    pulses whose windows left the buffer rather than stall trimming."""
    geo, _ = _geometry()
    n_steps = 60
    iq = _radar_iq(geo, n_steps)
    tables = FFT1Tables.create(geo, edge_taper=False)
    state = FFT1State.create(geo)
    tracker = RadarTracker(
        n_bins=geo.fft1_size, frame_time_s=geo.fft1_new_points / FS,
        params=RadarParams(time=2.0, lock_after=500))
    for s in range(n_steps):
        blk = jnp.asarray(
            iq[s * geo.samples_per_step:(s + 1) * geo.samples_per_step,
               None])
        state, spec, _ = fft1_step(geo, tables, state, blk, avg1num=64)
        tracker.feed(np.abs(np.asarray(spec)) ** 2)
    assert tracker.locked
    assert tracker.update_cnt >= 30
    buffered = sum(len(a) for a in tracker._hist_pw)
    keep = max(4 * tracker.pulse_sep + tracker.lines + 64,
               tracker.params.lock_after + 64)
    assert buffered <= keep + 32 * 2   # within one step of the bound


def test_radar_doppler_shifted_echo():
    """EME regime: the echo comes back doppler-shifted; echo_peak reads
    (range line, frequency offset, doppler Hz) off the display."""
    geo, _ = _geometry()
    stride = geo.fft1_new_points
    n_steps = 26
    n = n_steps * geo.samples_per_step
    period = PULSE_SEP_FRAMES * stride
    width = PULSE_WIDTH_FRAMES * stride
    delay = ECHO_DELAY_FRAMES * stride
    dopp_bins = 5
    rng = np.random.default_rng(9)
    env = radar_pulse_train(FS, FS / period, width / FS, n / FS,
                            rise_s=0.0002)[:n]
    t = np.arange(n)
    tx = env * np.exp(2j * np.pi * TX_BIN / geo.fft1_size * t)
    echo = np.zeros(n, np.complex128)
    ec = env * np.exp(2j * np.pi * (TX_BIN + dopp_bins)
                      / geo.fft1_size * t)
    echo[delay:] = 0.05 * ec[:-delay]
    nz = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    nz *= np.where(env > 0.01, 0.01, 1.0)
    iq = (tx + echo + nz).astype(np.complex64)

    tables = FFT1Tables.create(geo, edge_taper=False)
    state = FFT1State.create(geo)
    bin_hz = FS / geo.fft1_size
    tracker = RadarTracker(
        n_bins=geo.fft1_size, frame_time_s=geo.fft1_new_points / FS,
        bin_hz=bin_hz, params=RadarParams(time=2.0, lock_after=500))
    for s in range(n_steps):
        blk = jnp.asarray(
            iq[s * geo.samples_per_step:(s + 1) * geo.samples_per_step,
               None])
        state, spec, _ = fft1_step(geo, tables, state, blk, avg1num=64)
        tracker.feed(np.abs(np.asarray(spec)) ** 2)
    assert tracker.locked and tracker.pulse_bin == TX_BIN
    line, off, dopp = tracker.echo_peak()
    assert abs(line - ECHO_DELAY_FRAMES) <= 1
    assert off == dopp_bins
    assert dopp == pytest.approx(dopp_bins * bin_hz)
