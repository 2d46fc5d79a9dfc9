"""fft1 stage tests: parity vs numpy and scipy STFT."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as sps

from linrad_tpu import RxParams, derive_geometry
from linrad_tpu.ops.fft1 import FFT1State, FFT1Tables, fft1_step
from linrad_tpu.ops.windows import make_window
from linrad_tpu.io.siggen import Tone, tones_iq


def _geo(**kw):
    kw.setdefault("fft1_n_override", 9)
    return derive_geometry(RxParams(**kw))


class TestFFT1Path:
    """window -> FFT -> calibration -> power -> sumsq average against
    numpy, at the widths the earlier fused fft1 kernel was tested at."""

    @pytest.mark.parametrize("b,n,c", [(16, 256, 1), (40, 512, 2),
                                       (128, 1024, 1), (3, 128, 1)])
    def test_matches_numpy(self, b, n, c):
        geo = derive_geometry(RxParams(
            fft1_n_override=int(np.log2(n)), rx_rf_channels=c,
            target_fft1_frames_per_step=b))
        assert geo.fft1_size == n and geo.channels == c
        nfr = geo.fft1_frames_per_step
        rng = np.random.default_rng(7)
        fc = ((rng.normal(size=(n, c)) + 1j * rng.normal(size=(n, c)))
              * 0.1).astype(np.complex64)
        tables = FFT1Tables.create(geo, filtercorr=fc)
        state = FFT1State.create(geo)
        x = (rng.normal(size=(geo.samples_per_step, c))
             + 1j * rng.normal(size=(geo.samples_per_step, c))
             ).astype(np.complex64)
        new, spec, power = fft1_step(geo, tables, state, jnp.asarray(x),
                                     avg1num=8)
        pad = np.concatenate([np.zeros((geo.fft1_interleave_points, c),
                                       np.complex64), x])
        hop = geo.fft1_new_points
        frames = np.stack([pad[i * hop:i * hop + n] for i in range(nfr)])
        win = make_window(n, geo.fft1_sinpow)
        ref = np.fft.fft(frames * win[None, :, None], axis=1) * fc[None]
        ref_pow = np.mean(np.abs(ref) ** 2, axis=0)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(np.asarray(spec) / scale, ref / scale,
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(power), ref_pow, rtol=1e-4,
                                   atol=1e-6 * ref_pow.max())
        alpha = min(1.0, nfr / 8)
        np.testing.assert_allclose(np.asarray(new.sumsq_avg),
                                   1e-20 * (1 - alpha) + alpha * ref_pow,
                                   rtol=1e-4, atol=1e-6 * ref_pow.max())
        np.testing.assert_array_equal(
            np.asarray(new.tail), pad[-geo.fft1_interleave_points:])


class TestFFT1:
    def test_matches_scipy_stft(self):
        geo = _geo(first_fft_sinpow=2)
        tables = FFT1Tables.create(geo, edge_taper=False)
        state = FFT1State.create(geo)
        rng = np.random.default_rng(2)
        n = geo.samples_per_step
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64)
        block = jnp.asarray(x[:, None])
        _, spec, _ = fft1_step(geo, tables, state, block, avg1num=8)
        spec = np.asarray(spec)[:, :, 0]
        # scipy STFT over the zero-padded stream (the tail carry prepends
        # interleave zeros, matching frame 0's coverage)
        pad = np.concatenate([np.zeros(geo.fft1_interleave_points,
                                       np.complex64), x])
        win = make_window(geo.fft1_size, 2)
        nfr = spec.shape[0]
        for b in range(nfr):
            seg = pad[b * geo.fft1_new_points:
                      b * geo.fft1_new_points + geo.fft1_size]
            ref = np.fft.fft(seg * win)
            np.testing.assert_allclose(spec[b], ref, rtol=1e-3, atol=1e-2)

    def test_tone_lands_in_correct_bin(self):
        geo = _geo(first_fft_sinpow=2)
        fs = geo.rx_ad_speed
        k = 37
        f = k * fs / geo.fft1_size
        x = tones_iq(fs, geo.samples_per_step, [Tone(f)])
        tables = FFT1Tables.create(geo)
        state = FFT1State.create(geo)
        _, spec, power = fft1_step(geo, tables, state,
                                   jnp.asarray(x[:, None]), avg1num=8)
        p = np.asarray(power)[:, 0]
        assert int(np.argmax(p)) == k

    def test_streaming_equals_batch(self):
        geo = _geo()
        tables = FFT1Tables.create(geo, edge_taper=False)
        rng = np.random.default_rng(3)
        n = geo.samples_per_step
        x = (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n)).astype(
            np.complex64)[:, None]
        s = FFT1State.create(geo)
        s1, spec1, _ = fft1_step(geo, tables, s, jnp.asarray(x[:n]), 8)
        _, spec2, _ = fft1_step(geo, tables, s1, jnp.asarray(x[n:]), 8)
        # one big virtual step: frame the whole stream
        big = np.concatenate([np.asarray(spec1), np.asarray(spec2)])
        from linrad_tpu.ops.framing import frame_stream, make_tail
        tail = make_tail(geo.fft1_size, geo.fft1_new_points, (1,))
        frames, _ = frame_stream(tail, jnp.asarray(x), geo.fft1_size,
                                 geo.fft1_new_points)
        ref = np.fft.fft(np.asarray(frames)
                         * np.asarray(tables.window)[None, :, None], axis=1)
        np.testing.assert_allclose(big, ref, rtol=1e-3, atol=1e-2)

    def test_calibration_multiply(self):
        geo = _geo()
        fc = np.exp(1j * np.linspace(0, np.pi, geo.fft1_size)).astype(
            np.complex64)
        t_id = FFT1Tables.create(geo, edge_taper=False)
        t_fc = FFT1Tables.create(geo, filtercorr=fc)
        rng = np.random.default_rng(4)
        n = geo.samples_per_step
        x = (rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
             ).astype(np.complex64)
        s = FFT1State.create(geo)
        _, a, _ = fft1_step(geo, t_id, s, jnp.asarray(x), 8)
        _, b, _ = fft1_step(geo, t_fc, s, jnp.asarray(x), 8)
        np.testing.assert_allclose(np.asarray(a) * fc[None, :, None],
                                   np.asarray(b), rtol=1e-4, atol=1e-3)
