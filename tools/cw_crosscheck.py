"""Ours-vs-reference Morse crosscheck (VERDICT r3 #2).

What the reference can and cannot do in this codebase
-----------------------------------------------------
The reference's machine Morse decode (cwdetect.c/cwspeed.c/morse.c,
6,774 LoC) is an UNFINISHED feature in fventuri/linrad: the
coherent_cw_detect state machine hard-returns inside CWDETECT_CLEARED
before any speed detection can run (coherent.c:297 `return;//öö...`),
`cw_decode_region` is literally "do nothing" (cwdetect.c:4388),
`init_cw_decode` and `first_detect` force CWDETECT_DEBUG_STOP before
their work (cwdetect.c:4395, 3306), and several fitting paths are
skipped with `goto debug_x` (cwdetect.c:2486).  End-to-end RF->text
decoding therefore NEVER happens in the reference; it cannot produce a
character error rate at any SNR.

What IS complete and reachable-by-hand — ramp collection
(collect_ramp coherent.c:156), keying-spectrum speed estimation
(evaluate_keying_spectrum coherent.c:77), ideal-waveform construction
(make_ideal_waveform coherent.c:212 + store_symmetry_adapted_dash
cohsub.c:266) and the S/N-adaptive dash-fitting iteration
(detect_cw_speed cwspeed.c:577, find_good_dashes :496,
short_region_guesses :113) — is driven headless here through
tests/refharness (ref_cw_* entries) and compared against our
weak/cw.py on identical keyed-carrier-in-noise input.

Metrics per SNR (referred to 2500 Hz, the weak-signal convention):
  reference: waveform-established flag, cwbit estimate error, dashes
             found / true dash count
  ours:      full RF->text character error rate (decode_morse_ml via
             the Receiver chain), speed estimate error

Run: python tools/cw_crosscheck.py [--quick]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# a CPU correctness experiment: pin the CPU backend
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MSG = "CQ CQ DE SM5BSZ SM5BSZ K"
WPM = 20.0
FS = 96000.0
FC = 12000.0


def true_dash_count(text: str) -> int:
    from linrad_tpu.weak.cw import MORSE_ENCODE
    return sum(MORSE_ENCODE.get(c, "").count("-")
               for c in text.upper())


def edit_distance(a: str, b: str) -> int:
    m, n = len(a), len(b)
    d = list(range(n + 1))
    for i in range(1, m + 1):
        prev, d[0] = d[0], i
        for j in range(1, n + 1):
            cur = d[j]
            d[j] = min(d[j] + 1, d[j - 1] + 1,
                       prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return d[n]


def _keyed_iq(snr_db: float, seed: int, amp: float, reps: int = 2
              ) -> np.ndarray:
    from linrad_tpu.weak.cw import keyed_cw
    sig = keyed_cw((MSG + " ") * reps, FS, WPM, 0.0) * amp
    t = np.arange(len(sig)) / FS
    clean = sig * np.exp(2j * np.pi * FC * t)
    sigma = amp * np.sqrt(1.0 / (2 * (2500 / FS) * 10 ** (snr_db / 10)))
    rng = np.random.default_rng(seed)
    return (clean + sigma * (rng.standard_normal(len(sig))
                             + 1j * rng.standard_normal(len(sig)))
            ).astype(np.complex64)


def run_reference(snr_db: float, seed: int) -> dict:
    """Drive the reference's speed/segmentation front end headless."""
    from refharness import MODE_WCW, RefChain
    rc = RefChain(mode=MODE_WCW, ad_speed=int(FS), second_fft=0,
                  sinpow=2, cw_decode=True)
    newp = rc.geo("fft1_new_points")
    iq = np.round(_keyed_iq(snr_db, seed, amp=2000.0))
    rc.tune(FS / 2 + FC)
    ch = newp * 20
    for k in range(len(iq) // ch):
        rc.feed_iq(iq[k * ch:(k + 1) * ch])
        rc.run_wideband()
        rc.run_narrowband()
        rc.consume_audio()
        est = rc.cw_keying_eval()
        rc.cw_collect(est if est > 0 else 0.0)
    est = rc.cw_keying_eval()
    fs_bb = rc.geof("baseband_sampling_speed")
    true_bit = 1.2 / WPM * fs_bb
    out = {"est_bit_err_pct": (100 * abs(est - true_bit) / true_bit
                               if est > 0 else None)}
    flag = rc.cw_speed(est if est > 0 else true_bit)
    mids, _lens = rc.cw_dashes()
    out.update(
        flag=flag, established=(flag == 5), spun=(flag == -2),
        cwbit_err_pct=100 * abs(rc.cw_get("cwbit_pts") - true_bit)
        / true_bit,
        n_dash=int(rc.cw_get("no_of_cwdat")),
        n_dash_true=2 * true_dash_count(MSG))
    return out


def run_ours(snr_db: float, seed: int) -> dict:
    """Full RF->text decode through our Receiver chain."""
    from linrad_tpu.params import Demod, RxParams
    from linrad_tpu.pipeline.receiver import Receiver
    from linrad_tpu.weak.cw import decode_morse_ml

    p = RxParams(first_fft_bandwidth=30.0,
                 mix1_bandwidth_reduction_n=4, agc_enable=False,
                 afc_enable=True, demod=Demod.COHERENT, bfo_hz=600.0,
                 filter_low_hz=-100.0, filter_high_hz=100.0)
    rx = Receiver(p)
    g = rx.geo
    iq = _keyed_iq(snr_db, seed, amp=1.0)
    pad = (len(iq) // g.samples_per_step + 1) * g.samples_per_step
    iq = np.concatenate([iq, np.zeros(pad - len(iq), np.complex64)])
    rx.tune(FC)
    bb = np.concatenate(
        [np.asarray(o.baseb) for o in rx.run(iq)])[:, 0]
    res = decode_morse_ml(bb, g.baseband_sampling_speed)
    expect = ((MSG + " ") * 2).strip()
    return {"text": res.text, "wpm": res.wpm,
            "cer": edit_distance(res.text, expect),
            "msg_len": len(expect)}


def _run_point_subprocess(which: str, snr: float, seed: int,
                          timeout: float = 600.0) -> dict:
    """Run one sweep point in a subprocess: several reference loops
    (collect_ramp's key-up walk, find_good_dashes' ramp walk) have no
    iteration bound and can spin forever on noise-dominated ramps —
    a hang IS a result (the reference failing that SNR), recorded as
    {"hang": true}."""
    import json as _json
    import subprocess
    code = (f"import sys; sys.path.insert(0, {ROOT!r});"
            f"from tools.cw_crosscheck import run_reference, run_ours;"
            f"import json;"
            f"fn = run_reference if {which == 'ref'!r} else run_ours;"
            f"print('@@'+json.dumps(fn({snr!r}, {seed!r})))")
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout, cwd=ROOT)
        for line in out.stdout.splitlines():
            if line.startswith("@@"):
                return _json.loads(line[2:])
        return {"error": (out.stderr or "no output")[-300:]}
    except subprocess.TimeoutExpired:
        return {"hang": True}


def main():
    quick = "--quick" in sys.argv
    snrs = ([20.0, -2.0] if quick
            else [30.0, 20.0, 10.0, 4.0, 0.0, -2.0, -4.0, -6.0])
    seeds = [0] if quick else [0, 1]
    print(f"| SNR(2500Hz) | ref flag | ref cwbit err | ref dashes "
          f"| our CER | our text |")
    print("|---|---|---|---|---|---|")
    for snr in snrs:
        for seed in seeds:
            r = _run_point_subprocess("ref", snr, seed)
            o = _run_point_subprocess("ours", snr, seed)
            if "hang" in r or "error" in r:
                rf = "HANG" if r.get("hang") else "ERR"
                rbit, rdash = "-", "-"
            elif r.get("spun"):
                # the reference spun in an unbounded walk AFTER its
                # detection work — report the partials it left behind
                rf = "SPIN"
                rbit = f"{r['cwbit_err_pct']:.1f}%*"
                rdash = f"{r['n_dash']}/{r['n_dash_true']}*"
            else:
                rf = f"{r['flag']}{'*' if r['established'] else ''}"
                rbit = f"{r['cwbit_err_pct']:.1f}%"
                rdash = f"{r['n_dash']}/{r['n_dash_true']}"
            if "hang" in o or "error" in o:
                oc, ot = ("HANG" if o.get("hang") else
                          "ERR:" + o.get("error", "")[:60]), ""
            else:
                oc = f"{o['cer']}/{o['msg_len']}"
                ot = repr(o["text"][:40])
            print(f"| {snr:+.0f} dB s{seed} | {rf} | {rbit} | {rdash} "
                  f"| {oc} | {ot} |", flush=True)


if __name__ == "__main__":
    main()
