"""Production receiver serving pattern.

Wires the pieces a deployed station uses: streamed ingest -> the jitted
chain (AFC engaged) -> web GUI (waterfall/spectrum/live audio over
HTTP) with the failure-detection surfaces (heartbeat watchdog,
real-time margin, S-meter log) attached — the linrad "run it all day"
configuration as a ~60-line script.

    python examples/serve_rx.py [port]

Generates a drifting CW signal by default; feed a .wav path as the
second argument to serve a recording instead.
"""

import os
import sys
import tempfile

import numpy as np

from linrad_tpu import RxParams, derive_geometry
from linrad_tpu.io.httpd import WebGui
from linrad_tpu.io.siggen import Tone, tones_iq
from linrad_tpu.pipeline import Receiver
from linrad_tpu.runtime.watchdog import RealTimeMonitor, Watchdog
from linrad_tpu.utils.compile_cache import enable_compile_cache
from linrad_tpu.viz import SMeterLogger


def main(port: int = 8765, wav: str | None = None) -> None:
    enable_compile_cache()
    p = RxParams(first_fft_bandwidth=30.0, mix1_bandwidth_reduction_n=4,
                 afc_enable=True, filter_low_hz=-250.0,
                 filter_high_hz=250.0)
    geo = derive_geometry(p)
    rx = Receiver(p, audio_out_rate=48_000.0)
    fc = 10_000.0
    rx.tune(fc)

    if wav is not None:
        from linrad_tpu.io.wav import read_wav
        iq, info = read_wav(wav)
        assert info.sample_rate == geo.rx_ad_speed, info.sample_rate
    else:  # drifting carrier + noise, 20 s
        n = geo.samples_per_step * int(20 / (geo.samples_per_step
                                             / geo.rx_ad_speed))
        t = np.arange(n) / geo.rx_ad_speed
        rng = np.random.default_rng(1)
        iq = (0.3 * np.exp(2j * np.pi * (fc * t + 1.0 * t ** 2 / 2))
              + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
              ).astype(np.complex64)

    gui = WebGui(audio_rate=48_000, n_bins=geo.fft1_size)
    gui.attach(rx)
    port = gui.serve(port=port)
    print(f"web GUI: http://localhost:{port}/")

    wd = Watchdog(timeout_s=30.0)
    wd.start(lambda names: print(f"WATCHDOG: stalled {names}"))
    mon = RealTimeMonitor(rate_hz=geo.rx_ad_speed, headroom_s=2.0)
    fd, smeter_path = tempfile.mkstemp(suffix=".smeter")
    os.close(fd)
    smeter = SMeterLogger(
        smeter_path,
        step_seconds=geo.samples_per_step / geo.rx_ad_speed)

    steps = 0
    try:
        for out in rx.run(iq, watchdog=wd, monitor=mon):
            smeter.add(float(np.mean(np.abs(np.asarray(out.baseb)) ** 2)))
            steps += 1
            if steps % 50 == 0:
                print(f"step {steps}: margin {mon.margin_s:+.2f}s "
                      f"afc={rx.afc.status if rx.afc else '-'} "
                      f"f={rx.afc.freq_hz if rx.afc else 0:.1f} Hz")
    finally:
        wd.stop()
        gui.close()
    print(f"served {steps} steps; watchdog stalls: {wd.stalled()}")


if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8765
    wav = sys.argv[2] if len(sys.argv) > 2 else None
    main(port, wav)
