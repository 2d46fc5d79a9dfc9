"""Multi-sub-receiver demo: one wideband front end, K independently
tuned sub-receivers demodulated in a single vmapped kernel set.

This is the batched form of the reference's MIX1_NO_OF_CHANNELS=24
mix1 channel slots and of its network "userx" consumers (a master
multicasting the wideband pipeline to narrowband slaves,
globdef.h:315/1282-1294, z_NETWORK.txt) — instead of fanning stages out
over UDP to separate machines, the sub-receivers are a batch axis.

    python examples/demo_multirx.py
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from linrad_tpu import Demod, RxParams  # noqa: E402
from linrad_tpu.io.siggen import Tone, gaussian_noise, tones_iq  # noqa: E402
from linrad_tpu.pipeline import MultiReceiver  # noqa: E402
from linrad_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,E501


def main():
    enable_compile_cache()
    p = RxParams(first_fft_bandwidth=100.0,
                 mix1_bandwidth_reduction_n=4, demod=Demod.SSB,
                 bfo_hz=800.0)
    n_subch = 8
    mrx = MultiReceiver(p, n_subch=n_subch)
    g = mrx.geo

    # a band with 8 stations, one per sub-receiver
    rng = np.random.default_rng(7)
    stations = [6_000.0 + 4_000.0 * k for k in range(n_subch)]
    n = g.samples_per_step * 8
    iq = tones_iq(g.rx_ad_speed, n,
                  [Tone(f + 400.0, amplitude=10 ** (-k / 8))
                   for k, f in enumerate(stations)])
    iq = (iq + gaussian_noise(rng, n, level_bits=-12)).astype(np.complex64)

    for k, f in enumerate(stations):
        mrx.tune_subch(k, f)

    t0 = time.time()
    audio = []
    for out in mrx.run(iq):
        audio.append(np.asarray(out.audio))
    audio = np.concatenate(audio, axis=1)  # (K, S, C)
    dt = time.time() - t0

    print(f"{n_subch} sub-receivers x {n / g.rx_ad_speed:.2f}s of band "
          f"in {dt:.2f}s wall")
    for k in range(n_subch):
        a = audio[k, audio.shape[1] // 3:, 0]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        fpk = np.fft.rfftfreq(len(a), 1 / g.baseband_sampling_speed)[
            np.argmax(spec)]
        print(f"  subch {k}: tuned {stations[k]/1e3:7.1f} kHz -> "
              f"audio peak {fpk:6.1f} Hz, rms {a.std():.3f}")


if __name__ == "__main__":
    main()
