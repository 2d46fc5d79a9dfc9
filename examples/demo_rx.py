"""End-to-end demo: weak CW in noise and pulses -> decoded text.

Synthesises the kind of signal Linrad was built for (weak keyed CW with
impulse noise, the EME/weak-signal use case), runs the full wideband +
narrowband chain with blankers and AFC off/on, decodes the Morse, and
writes waterfall/audio artifacts.

    python examples/demo_rx.py [out_dir]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from linrad_tpu import RxParams  # noqa: E402
from linrad_tpu.io.siggen import impulse_noise, gaussian_noise  # noqa: E402
from linrad_tpu.io.wav import write_wav  # noqa: E402
from linrad_tpu.pipeline import Receiver  # noqa: E402
from linrad_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,E501
from linrad_tpu.utils.timing import StepTimer  # noqa: E402
from linrad_tpu.viz import Waterfall, save_pgm, spectrum_db  # noqa: E402
from linrad_tpu.weak.cw import (decode_morse, decode_morse_ml,  # noqa: E402
                                keyed_cw)


def main(out_dir: str = "demo_out"):
    enable_compile_cache()
    os.makedirs(out_dir, exist_ok=True)
    p = RxParams(
        first_fft_bandwidth=100.0,
        mix1_bandwidth_reduction_n=4,
        second_fft_enable=True,
        blanker_enable=True,
        clever_bln_limit=6.0,
        stupid_bln_limit=4.0,
        max_pulses_per_block=64,
        agc_enable=True,
        bfo_hz=700.0,
        filter_low_hz=-400.0,
        filter_high_hz=400.0,
    )
    rx = Receiver(p)
    g = rx.geo
    fs = g.rx_ad_speed
    print(f"geometry: fft1={g.fft1_size} fft2={g.fft2_size} "
          f"mix1={g.mix1_size} fs_bb={g.baseband_sampling_speed:.0f} Hz "
          f"step={g.samples_per_step} samples")

    msg = "CQ CQ DE SM5BSZ SM5BSZ K"
    cw = keyed_cw(msg, fs, wpm=18, tone_hz=12_000.0, amplitude=0.2)
    pad = (-len(cw)) % g.samples_per_step
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    rng = np.random.default_rng(7)
    iq = (cw + gaussian_noise(rng, len(cw), level_bits=-9)
          + impulse_noise(rng, len(cw), rate_hz=40.0, fs=fs,
                          amplitude=10.0))
    print(f"signal: {len(iq)/fs:.1f} s of 96 kHz IQ, CW at 0.2 amp, "
          f"noise + 40 pulses/s at 50x signal amplitude")

    rx.tune(12_000.0)
    wf = Waterfall(n_bins=g.fft2_size, depth=512)
    timer = StepTimer(fs, g.samples_per_step)
    audio = []
    fitted = 0
    for blk in range(len(iq) // g.samples_per_step):
        timer.start()
        out = rx.process_block(
            iq[blk * g.samples_per_step:(blk + 1) * g.samples_per_step,
               None])
        timer.stop(out.audio)
        audio.append(np.asarray(out.audio))
        fitted += int(out.blanker_fitted)
        wf.add(np.asarray(out.fft2_power))
    audio = np.concatenate(audio)[:, 0]
    print(f"throughput: {timer.report()}")
    print(f"blanker: {fitted} pulses subtracted")

    res = decode_morse(audio, g.baseband_sampling_speed)
    print(f"decoded (matched-filter) @ {res.wpm:.0f} WPM: {res.text!r}")
    res_ml = decode_morse_ml(audio, g.baseband_sampling_speed)
    print(f"decoded (ML grammar)     @ {res_ml.wpm:.0f} WPM:"
          f" {res_ml.text!r}")
    print("expected:", repr(msg))

    write_wav(f"{out_dir}/audio.wav",
              (audio * 20_000)[:, None].astype(np.float32),
              int(g.baseband_sampling_speed))
    save_pgm(f"{out_dir}/waterfall.pgm", wf.image())
    print(f"artifacts in {out_dir}: audio.wav, waterfall.pgm")


if __name__ == "__main__":
    main(*sys.argv[1:2])
