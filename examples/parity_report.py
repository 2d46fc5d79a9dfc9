"""Run the five BASELINE.json benchmark configs and report metrics.

    python examples/parity_report.py [out.md]

1. fft1 wideband spectrum on a 96 kHz SSB IQ recording
2. caliq I/Q balance calibration + fft1 windowing
3. timf2 smart blanker + sellim on the back-transformed series
4. fft2/fft3 + mix1/mix2 + SSB demod to audio
5. weak-signal CW chain (AFC + coherent + Morse decode)

Runs on JAX's default device; JAX_PLATFORMS=cpu runs it on the CPU.
"""

import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")

from linrad_tpu import RxParams, derive_geometry  # noqa: E402
from linrad_tpu.calibration import (apply_iq_correction,  # noqa: E402
                                    estimate_iq_balance, iq_imbalance)
from linrad_tpu.io.siggen import (Tone, gaussian_noise,  # noqa: E402
                                  impulse_noise, tones_iq)
from linrad_tpu.pipeline import Receiver  # noqa: E402
from linrad_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,E501
from linrad_tpu.weak.cw import decode_morse, keyed_cw  # noqa: E402

LINES = []


def log(s=""):
    print(s)
    LINES.append(s)


def tone_snr(z, f, fs):
    t = np.arange(len(z)) / fs
    ref = np.exp(2j * np.pi * f * t)
    amp = np.vdot(ref, z) / len(z)
    r = z - amp * ref
    return abs(amp), 10 * np.log10(
        np.vdot(z, z).real / max(np.vdot(r, r).real, 1e-30))


def config1():
    p = RxParams(first_fft_bandwidth=100.0, agc_enable=False)
    rx = Receiver(p)
    g = rx.geo
    iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 4,
                  [Tone(12_000.0), Tone(-20_000.0, amplitude=0.1)])
    rx.tune(12_000.0)
    out = None
    for out in rx.run(iq):
        pass
    pwr = np.sum(np.asarray(out.fft1_avg_power), axis=-1)
    k1 = int(round(12_000.0 / g.rx_ad_speed * g.fft1_size))
    k2 = int(round(-20_000.0 / g.rx_ad_speed * g.fft1_size)) % g.fft1_size
    ok1 = abs(int(np.argmax(pwr)) - k1) <= 1
    rel_db = 10 * np.log10(pwr[k2] / pwr[k1])
    log(f"| 1 fft1 spectrum | peak at correct bin: {ok1}; "
        f"-20 dB tone measured {rel_db:.1f} dB | PASS |")


def config2():
    geo = derive_geometry(RxParams(fft1_n_override=9))
    rng = np.random.default_rng(1)
    n = geo.fft1_size * 1024
    train = (rng.normal(size=n) + 1j * rng.normal(size=n)
             ).astype(np.complex64)
    c = estimate_iq_balance(iq_imbalance(train, 1.05, 0.03), geo)
    tone = tones_iq(geo.rx_ad_speed, geo.fft1_size * 4, [Tone(10_000.0)])
    bad = iq_imbalance(tone, 1.05, 0.03)
    spec = np.fft.fft(bad.reshape(4, geo.fft1_size, 1), axis=1)
    fixed = apply_iq_correction(spec, c)
    k = int(round(10_000.0 / geo.rx_ad_speed * geo.fft1_size))
    mk = (-k) % geo.fft1_size
    before = np.abs(spec[:, mk, 0]).mean() / np.abs(spec[:, k, 0]).mean()
    after = np.abs(fixed[:, mk, 0]).mean() / np.abs(fixed[:, k, 0]).mean()
    imp = 20 * np.log10(before / after)
    log(f"| 2 caliq I/Q balance | image improved {imp:.1f} dB "
        f"(to {-20 * np.log10(after):.1f} dB rejection) | "
        f"{'PASS' if imp > 15 else 'FAIL'} |")


def config34():
    base = dict(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                second_fft_enable=True, agc_enable=False,
                clever_bln_limit=6.0, stupid_bln_limit=4.0,
                max_pulses_per_block=64)
    rng = np.random.default_rng(0)
    snrs = {}
    fits = 0
    iq = None
    for bl in (True, False):
        rx = Receiver(RxParams(**base, blanker_enable=bl))
        g = rx.geo
        if iq is None:
            fs = g.rx_ad_speed
            n = g.samples_per_step * 6
            iq = (tones_iq(fs, n, [Tone(12_400.0)])
                  + gaussian_noise(rng, n, -11)
                  + impulse_noise(rng, n, 50.0, fs, 30.0))
        rx.tune(12_000.0)
        outs = list(rx.run(iq))
        z = np.concatenate([np.asarray(o.baseb) for o in outs])[:, 0]
        _, snrs[bl] = tone_snr(z[len(z) // 2:], 400.0,
                               g.baseband_sampling_speed)
        if bl:
            fits = sum(int(o.blanker_fitted) for o in outs)
    gain = snrs[True] - snrs[False]
    log(f"| 3 sellim + smart blanker | {fits} pulses subtracted; "
        f"SNR {snrs[False]:.1f} -> {snrs[True]:.1f} dB (+{gain:.1f}) | "
        f"{'PASS' if gain > 10 else 'FAIL'} |")
    # config 4: demod fidelity (amplitude-true tone through full chain)
    rx = Receiver(RxParams(**base, blanker_enable=False))
    g = rx.geo
    clean = tones_iq(g.rx_ad_speed, g.samples_per_step * 6,
                     [Tone(12_400.0)])
    rx.tune(12_000.0)
    z = np.concatenate([np.asarray(o.baseb) for o in rx.run(clean)])[:, 0]
    amp, snr = tone_snr(z[len(z) // 2:], 400.0, g.baseband_sampling_speed)
    log(f"| 4 fft2/fft3+mix+SSB demod | amplitude {amp:.4f} (true=1), "
        f"clean-tone SNR {snr:.1f} dB | "
        f"{'PASS' if abs(amp - 1) < 0.01 and snr > 60 else 'FAIL'} |")


def config5():
    p = RxParams(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                 agc_enable=False, bfo_hz=700.0, filter_low_hz=-400.0,
                 filter_high_hz=400.0)
    rx = Receiver(p)
    g = rx.geo
    msg = "CQ CQ DE SM5BSZ"
    cw = keyed_cw(msg, g.rx_ad_speed, 20, 12_000.0)
    pad = (-len(cw)) % g.samples_per_step
    rng = np.random.default_rng(1)
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    cw = cw + 0.02 * (rng.normal(size=len(cw))
                      + 1j * rng.normal(size=len(cw))).astype(np.complex64)
    rx.tune(12_000.0)
    audio = np.concatenate([np.asarray(o.audio) for o in rx.run(cw)])[:, 0]
    res = decode_morse(audio, g.baseband_sampling_speed)
    ok = res.text == msg
    log(f"| 5 weak-signal CW chain | decoded {res.text!r} @ "
        f"{res.wpm:.0f} WPM (sent {msg!r}) | {'PASS' if ok else 'FAIL'} |")


def main(out_path=None):
    enable_compile_cache()
    t0 = time.time()
    log("# BASELINE config parity report")
    log()
    log("| config | result | status |")
    log("|---|---|---|")
    config1()
    config2()
    config34()
    config5()
    log()
    log(f"_generated in {time.time() - t0:.0f}s on "
        f"{jax.devices()[0].device_kind}_")
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(LINES) + "\n")


if __name__ == "__main__":
    main(*sys.argv[1:2])
