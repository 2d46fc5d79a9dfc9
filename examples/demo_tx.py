"""TX-chain demo: mic audio -> speech processor -> SSB -> self-analysis.

Exercises the transmit side end-to-end (the reference's TX + MODE_TXTEST
surface, tx.c / txssb.c / txtest.c): synthetic two-tone "mic" audio runs
through the SSB speech processor, is modulated to an SSB IQ stream,
analysed with txtest (IMD3, occupied bandwidth), and a CW identification
with shaped keying plus a radar pulse train round out the keying paths.

    python examples/demo_tx.py [out_dir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, ".")

from linrad_tpu.io.wav import write_wav                    # noqa: E402
from linrad_tpu.modes import powtim, txtest                # noqa: E402
from linrad_tpu.tx import (ascii_keying, cw_envelope,      # noqa: E402
                           radar_pulse_train, ssb_modulate)
from linrad_tpu.tx.ssbproc import SSBProcessor             # noqa: E402
from linrad_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,E501


def main(out_dir: str = "demo_tx_out"):
    enable_compile_cache()
    os.makedirs(out_dir, exist_ok=True)
    fs = 8000.0

    # --- SSB voice path: two-tone test signal through the processor ---
    t = np.arange(int(4 * fs)) / fs
    mic = (0.4 * np.sin(2 * np.pi * 700.0 * t)
           + 0.4 * np.sin(2 * np.pi * 1900.0 * t)).astype(np.float64)
    proc = SSBProcessor(fs)
    shaped = proc.process(mic)
    tx_iq = ssb_modulate(shaped, fs, usb=True)
    res = txtest(tx_iq, fs)
    print(f"SSB two-tone: carrier {res.carrier_hz:+.0f} Hz, "
          f"occupied BW {res.occupied_bw_hz:.0f} Hz, "
          f"IMD3 {res.imd3_db:.1f} dBc")
    write_wav(f"{out_dir}/ssb_iq.wav",
              np.stack([tx_iq.real, tx_iq.imag], 1).astype(np.float32)
              * 20000, int(fs))

    # --- CW identification with rise-time-shaped keying ---
    key = ascii_keying("TEST DE SM5BSZ", fs, wpm=20)
    env = cw_envelope(key, fs, rise_s=0.005)
    cw_iq = (env * np.exp(2j * np.pi * 600.0 * np.arange(len(env)) / fs)
             ).astype(np.complex64)
    times, power = powtim(cw_iq, fs)
    duty = float(np.mean(power > 0.5 * power.max()))
    print(f"CW id: {len(env)/fs:.1f} s, keying duty {duty:.2f}, "
          f"power-vs-time windows {len(times)}")

    # --- radar pulse train (EME radar mode TX) ---
    train = radar_pulse_train(fs, prf_hz=10.0, pulse_s=0.01,
                              duration_s=2.0)
    print(f"radar train: {len(train)/fs:.1f} s, "
          f"~{int(round(train.sum() / (0.01 * fs)))} pulses")
    print(f"artifacts in {out_dir}: ssb_iq.wav")


if __name__ == "__main__":
    main(*sys.argv[1:2])
