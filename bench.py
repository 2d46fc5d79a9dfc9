"""Throughput benchmark: complex Msamples/s/chip through the full
fft1 -> sellim -> back-FFT -> blanker -> fft2 -> mix1 -> fft3 -> mix2 ->
SSB demod chain (BASELINE.md metric).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s/chip",
   "vs_baseline": N, "vs_xlinrad": N, "xlinrad_msps": N,
   "vs_numpy": N, "flops_per_sample": N, "achieved_tflops": N,
   "config": {...}, "scaling": {...}}

vs_baseline == vs_xlinrad: the ratio against the ACTUAL reference DSP
chain — the mounted tree's C sources compiled into libref.so
(tests/refharness) and driven through fft1 -> sellim -> timf2 ->
blanker -> fft2 -> mix1 -> fft3 -> mix2 at the same sample format on
one CPU core (the xlinrad64 single-Xeon stand-in; the reference repo
publishes no numbers, BASELINE.md).  vs_numpy keeps the older
numpy-sketch comparison for continuity.  Both CPU numbers are measured
once and cached in .bench_cpu_baseline.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(_HERE, ".bench_cpu_baseline.json")


def _params(**overrides):
    from linrad_tpu import RxParams
    kw = dict(
        rx_ad_speed=96_000,
        first_fft_bandwidth=100.0,
        mix1_bandwidth_reduction_n=4,
        second_fft_enable=True,
        blanker_enable=True,
        agc_enable=True,
        clever_bln_limit=6.0,
        stupid_bln_limit=4.0,
        max_pulses_per_block=64,
        target_fft1_frames_per_step=256,
        blanker_block_size=0,
    )
    kw.update(overrides)
    return RxParams(**kw)


def bench_chain(steps: int = 150, warmup: int = 10, windows: int = 3,
              **overrides) -> float:
    """Msamples/s through the jitted chain on the default device."""
    import jax
    import jax.numpy as jnp

    from linrad_tpu import derive_geometry
    from linrad_tpu.ops.blanker import BlankerTables
    from linrad_tpu.pipeline.chain import RxState, RxTables, make_rx_step

    p = _params(**overrides)
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p)
    state = RxState.create(geo)
    _, pw = BlankerTables.create(geo)
    step = jax.jit(make_rx_step(geo, p, blanker_pulsewidth=pw),
                   donate_argnums=(1,))

    rng = np.random.default_rng(0)
    n = geo.samples_per_step
    t = np.arange(n)
    sig = (np.exp(2j * np.pi * 0.13 * t)
           + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    sig[::9973] += 30.0  # pulses so the blanker does real work
    from linrad_tpu.utils.xfer import device_complex
    block = device_complex(sig[:, None])
    tune = jnp.asarray(1024, jnp.int32)

    for _ in range(warmup):
        state, out = step(tables, state, block, tune)
    jax.block_until_ready(out.audio)
    # best of several measurement windows; the spread is reported too
    best = 0.0
    LAST_WINDOWS.clear()
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(tables, state, block, tune)
        jax.block_until_ready(out.audio)
        dt = time.perf_counter() - t0
        LAST_WINDOWS.append(steps * n / dt / 1e6)
        best = max(best, steps * n / dt / 1e6)
    return best


# per-window measurements of the most recent bench_* call, so main()
# can report best/median/spread (round-over-round reproducibility —
# best-only numbers are indistinguishable from environment luck)
LAST_WINDOWS: list = []


def window_stats(ws) -> dict:
    if not ws:
        return {}
    ws = sorted(ws)
    med = ws[len(ws) // 2] if len(ws) % 2 else 0.5 * (
        ws[len(ws) // 2 - 1] + ws[len(ws) // 2])
    return {"best": round(ws[-1], 2), "median": round(med, 2),
            "spread": round((ws[-1] - ws[0]) / med, 3)
            if med else None, "n_windows": len(ws)}


def bench_batched(k_steps: int = 16, dispatches: int = 12,
                      windows: int = 3, **overrides) -> float:
    """Throughput mode: K chain steps per device dispatch via the
    lax.scan BatchRunner (pipeline/batch.py).  File processing is
    throughput-bound, not latency-bound (SURVEY.md §7 hard part 4), and
    scanning K steps per dispatch amortizes the dispatch cost."""
    import jax
    import jax.numpy as jnp

    from linrad_tpu.pipeline.batch import BatchRunner

    br = BatchRunner(_params(**overrides), k_steps=k_steps,
                     outputs=("audio",))
    geo = br.geo
    n = geo.samples_per_step

    rng = np.random.default_rng(0)
    t = np.arange(n)
    sig = (np.exp(2j * np.pi * 0.13 * t)
           + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    sig[::9973] += 30.0  # pulses so the blanker does real work
    from linrad_tpu.utils.xfer import device_complex
    blocks = device_complex(
        np.broadcast_to(sig[None, :, None], (k_steps, n, 1)).copy())
    tune = jnp.asarray(1024, jnp.int32)

    state = br.state
    for _ in range(2):  # compile + warm
        state, outs = br._run_k(br.tables, state, blocks, tune)
    jax.block_until_ready(outs)
    best = 0.0
    LAST_WINDOWS.clear()
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(dispatches):
            state, outs = br._run_k(br.tables, state, blocks, tune)
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        LAST_WINDOWS.append(dispatches * k_steps * n / dt / 1e6)
        best = max(best, dispatches * k_steps * n / dt / 1e6)
    return best


def bench_sharded_1dev(k_steps: int = 16, dispatches: int = 6,
                       windows: int = 3, **overrides) -> float:
    """The cooperative sharded step compiled for a 1-device mesh on the
    real chip: its throughput vs the plain chain is the sharding
    overhead (shard_map partitioning, gathers that become copies).
    The multi-device correctness of the same program is covered by the
    8-device CPU-mesh tests + dryrun_multichip."""
    import jax
    import jax.numpy as jnp

    from linrad_tpu.parallel.sharded import ShardedBatchRunner

    sb = ShardedBatchRunner(_params(**overrides), k_steps=k_steps,
                            outputs=("audio",),
                            devices=jax.devices()[:1])
    geo = sb.geo
    n = geo.samples_per_step
    rng = np.random.default_rng(0)
    t = np.arange(n)
    sig = (np.exp(2j * np.pi * 0.13 * t)
           + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    sig[::9973] += 30.0
    from linrad_tpu.utils.xfer import device_complex
    blocks = device_complex(
        np.broadcast_to(sig[None, :, None], (k_steps, n, 1)).copy())
    state = sb.state
    for _ in range(2):
        state, outs = sb._run_k(sb.tables, state, blocks, sb._tune_bin)
    jax.block_until_ready(outs)
    float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))     # warm fetch
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(dispatches):
            state, outs = sb._run_k(sb.tables, state, blocks,
                                    sb._tune_bin)
        float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))
        dt = time.perf_counter() - t0
        best = max(best, dispatches * k_steps * n / dt / 1e6)
    return best


def bench_cpu_reference(max_seconds: float = 20.0) -> float:
    """Single-threaded numpy implementation of the same chain — the
    single-Xeon reference-class baseline (Msamples/s)."""
    from linrad_tpu import derive_geometry
    from linrad_tpu.ops.windows import make_window, synthesis_weights

    p = _params()
    geo = derive_geometry(p)
    n = geo.samples_per_step
    rng = np.random.default_rng(0)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    win1 = make_window(geo.fft1_size, geo.fft1_sinpow).astype(np.float32)
    win2 = make_window(geo.fft2_size, geo.fft2_sinpow).astype(np.float32)
    syn1 = synthesis_weights(geo.fft1_size, geo.fft1_interleave_points,
                             geo.fft1_sinpow).astype(np.float32)
    m = geo.mix1_size

    def one_step(x):
        # fft1
        nf = geo.fft1_frames_per_step
        hop = geo.fft1_new_points
        frames = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([np.zeros(geo.fft1_interleave_points,
                                     np.complex64), x]),
            geo.fft1_size)[::hop][:nf]
        spec = np.fft.fft(frames * win1, axis=1)
        # split + back fft (two inverse transforms per frame)
        wmask = np.ones(geo.fft1_size, np.float32)
        wmask[100:110] = 0
        weak = np.fft.ifft(spec * wmask, axis=1) * syn1
        strong = np.fft.ifft(spec * (1 - wmask), axis=1) * syn1
        # overlap-add
        wk = np.zeros(n + geo.fft1_size, np.complex64)
        st = np.zeros(n + geo.fft1_size, np.complex64)
        for b in range(nf):
            wk[b * hop: b * hop + geo.fft1_size] += weak[b]
            st[b * hop: b * hop + geo.fft1_size] += strong[b]
        wk = wk[:n]
        pwr = np.abs(wk) ** 2
        # stupid blanker + simplified clever pass (16 peak subtractions)
        thr = 16 * np.mean(pwr)
        mask = pwr > thr
        wk[mask] = 0
        for _ in range(16):
            pk = np.argmax(pwr)
            if pwr[pk] < thr:
                break
            wk[pk] = 0
            pwr[pk] = 0
        timf2 = wk + st[:n]
        # fft2
        nf2 = geo.fft2_frames_per_step
        hop2 = geo.fft2_new_points
        f2 = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([np.zeros(geo.fft2_interleave_points,
                                     np.complex64), timf2]),
            geo.fft2_size)[::hop2][:nf2]
        spec2 = np.fft.fft(f2 * win2, axis=1)
        # mix1: select m bins, ifft, OLA (decimated)
        sel = np.concatenate([spec2[:, :m // 2], spec2[:, -m // 2:]],
                             axis=1)
        y = np.fft.ifft(sel, axis=1)
        hop_m = geo.mix1_new_points
        t3 = np.zeros(nf2 * hop_m + m, np.complex64)
        for b in range(nf2):
            t3[b * hop_m: b * hop_m + m] += y[b]
        t3 = t3[: nf2 * hop_m]
        # fft3 + mix2 + demod (decimated, cheap)
        n3 = geo.fft3_size
        hop3 = geo.fft3_new_points
        k3 = len(t3) // hop3 - 1
        if k3 > 0:
            f3 = np.lib.stride_tricks.sliding_window_view(t3, n3)[::hop3][:k3]
            s3 = np.fft.fft(f3, axis=1)
            bb = np.fft.ifft(s3[:, : geo.mix2_size], axis=1)
            audio = np.real(bb * np.exp(2j * np.pi * 0.1
                                        * np.arange(bb.shape[1])))
        return audio

    # time it
    one_step(x)  # warm numpy caches
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < max_seconds and reps < 50:
        one_step(x)
        reps += 1
    dt = time.perf_counter() - t0
    return reps * n / dt / 1e6


def bench_xlinrad(max_seconds: float = 20.0) -> float | None:
    """Throughput of the ACTUAL reference chain: the mounted tree's C
    sources compiled headless (tests/refharness) and driven through
    fft1_b/fft1_c -> fft1_update_liminfo -> make_timf2 ->
    first_noise_blanker -> make_fft2 -> fft2_mix1 -> make_fft3_all ->
    fft3_mix2 on one core — the xlinrad64 single-Xeon stand-in.

    Same workload class as the device bench: 96 kHz IQ, a carrier + noise
    + blanker-triggering pulses, second FFT on, stupid blanker in auto
    mode (the clever blanker requires amplitude calibration and is off
    in the reference too).  Returns Msamples/s, or None when the
    reference tree is not mounted."""
    sys.path.insert(0, os.path.join(_HERE, "tests"))
    try:
        from refharness import RefChain, available, load
    except Exception:
        return None
    if not available():
        return None
    rc = RefChain(ad_speed=96_000, second_fft=1, sinpow=2)
    rc.set_hg("clever_bln_mode", 0)   # uncalibrated: forced off anyway
    rc.set_hg("stupid_bln_mode", 1)
    rc.tune(48_000.0 + 12_000.0)
    lib = load()
    newp = rc.geo("fft1_new_points")
    chunk = newp * 16
    rng = np.random.default_rng(0)
    t = np.arange(chunk)
    sig = (1000.0 * np.exp(2j * np.pi * 0.13 * t)
           + 20.0 * (rng.normal(size=chunk)
                     + 1j * rng.normal(size=chunk)))
    sig[::9973] += 30_000.0   # same pulse cadence as the device bench
    sig = np.round(np.clip(sig.real, -32767, 32767)
                   + 1j * np.clip(sig.imag, -32767, 32767))
    scratch = np.empty((1 << 18, 2), np.float32).reshape(-1)

    def one_chunk():
        rc.feed_iq(sig)
        rc.run_wideband()
        rc.run_narrowband()
        lib.ref_consume_audio(scratch, 1 << 17)

    for _ in range(8):            # warm: noise floor + caches settle
        one_chunk()
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < max_seconds:
        one_chunk()
        done += 1
    dt = time.perf_counter() - t0
    return done * chunk / dt / 1e6


def chain_flops_per_sample(geo) -> float:
    """FLOPs per input sample through the wideband+narrowband chain.

    Analytic accounting: a complex radix FFT ≈ 5·N·log2(N) real FLOPs
    (the classical FFT-equivalent work); windowing/calibration/blanker/
    elementwise work is counted at 1 complex MAC (8 FLOPs) per touch."""
    import math

    def fft(n):
        return 5.0 * n * math.log2(n)

    f = 0.0
    # fft1: one N1 FFT per hop of new samples (+ window + calibration)
    f += (fft(geo.fft1_size) + 16 * geo.fft1_size) / geo.fft1_new_points
    if geo.second_fft_enable:
        # back transform: two inverse FFTs (weak/strong) + OLA
        f += 2 * (fft(geo.fft1_size) + 8 * geo.fft1_size) \
            / geo.fft1_new_points
        # fft2
        f += (fft(geo.fft2_size) + 8 * geo.fft2_size) \
            / geo.fft2_new_points
    # mix1 inverse FFT over the decimated selection
    f += (fft(geo.mix1_size) + 8 * geo.mix1_size) / geo.fftx_new_points
    # narrowband (fft3 + mix2 ifft) on the decimated stream
    decim = geo.timf1_sampling_speed / geo.timf3_sampling_speed
    f += ((fft(geo.fft3_size) + 8 * geo.fft3_size) / geo.fft3_new_points
          + (fft(geo.mix2_size) + 8 * geo.mix2_size)
          / geo.fft3_new_points) / decim
    return f


def bench_roofline(msps: float, **overrides) -> dict:
    """Translate a measured Msamples/s into achieved TFLOP/s through
    the chain (FFT-equivalent 5·N·log2(N) accounting)."""
    from linrad_tpu import derive_geometry

    geo = derive_geometry(_params(**overrides))
    fps = chain_flops_per_sample(geo)
    return {"flops_per_sample": round(fps, 1),
            "achieved_tflops": round(msps * 1e6 * fps / 1e12, 3)}


def bench_stream_fetch(steps: int = 12, windows: int = 3,
                       **overrides) -> float:
    """Streamed single-step dispatches with a terminal fetch barrier:
    successive dispatches overlap on device while the state dependency
    chains them, and the final fetch of a scalar from the last step's
    output bounds the completion of all of them.  Returns Msamples/s (best
    window); per-window values land in LAST_WINDOWS."""
    import jax
    import jax.numpy as jnp

    from linrad_tpu import derive_geometry
    from linrad_tpu.ops.blanker import BlankerTables
    from linrad_tpu.pipeline.chain import RxState, RxTables, make_rx_step

    p = _params(**overrides)
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p)
    state = RxState.create(geo)
    _, pw = BlankerTables.create(geo)
    step = jax.jit(make_rx_step(geo, p, blanker_pulsewidth=pw),
                   donate_argnums=(1,))
    rng = np.random.default_rng(0)
    n = geo.samples_per_step
    t = np.arange(n)
    sig = (np.exp(2j * np.pi * 0.13 * t)
           + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    sig[::9973] += 30.0
    from linrad_tpu.utils.xfer import device_complex
    block = device_complex(sig[:, None])
    tune = jnp.asarray(1024, jnp.int32)
    for _ in range(2):
        state, out = step(tables, state, block, tune)
    float(np.asarray(jnp.sum(jnp.abs(out.audio))))    # warm + barrier
    best = 0.0
    LAST_WINDOWS.clear()
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(tables, state, block, tune)
        float(np.asarray(jnp.sum(jnp.abs(out.audio))))
        dt = time.perf_counter() - t0
        LAST_WINDOWS.append(steps * n / dt / 1e6)
        best = max(best, steps * n / dt / 1e6)
    return best


def bench_fetch_verified(k_steps: int = 16, dispatches: int = 3,
                         **overrides) -> dict:
    """Timing-integrity probe: time dispatches INCLUDING a device->host
    fetch of a scalar reduced from the final dispatch's outputs.

    Since every dispatch chains state, fetching one scalar from the LAST
    dispatch's output bounds the completion time of ALL dispatches.
    Reports both timings; their ratio is the cost of the host fetch."""
    import jax
    import jax.numpy as jnp

    from linrad_tpu.pipeline.batch import BatchRunner

    br = BatchRunner(_params(**overrides), k_steps=k_steps,
                     outputs=("audio",))
    n = br.geo.samples_per_step
    rng = np.random.default_rng(0)
    t = np.arange(n)
    sig = (np.exp(2j * np.pi * 0.13 * t)
           + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    sig[::9973] += 30.0
    from linrad_tpu.utils.xfer import device_complex
    blocks = device_complex(
        np.broadcast_to(sig[None, :, None], (k_steps, n, 1)).copy())
    tune = jnp.asarray(1024, jnp.int32)
    state = br.state
    for _ in range(2):
        state, outs = br._run_k(br.tables, state, blocks, tune)
    jax.block_until_ready(outs)
    float(jnp.sum(outs[0][-1]))          # warm the reduce + fetch path
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, outs = br._run_k(br.tables, state, blocks, tune)
    jax.block_until_ready(outs)
    t_block = time.perf_counter() - t0
    s = jnp.sum(outs[0][-1])             # depends on every dispatch
    chk = float(np.asarray(s))           # true completion barrier
    t_fetch = time.perf_counter() - t0
    total = dispatches * k_steps * n
    return {"msps_block_until_ready": round(total / t_block / 1e6, 2),
            "msps_fetch_verified": round(total / t_fetch / 1e6, 2),
            "fetch_over_block_ratio": round(t_fetch / t_block, 2),
            "checksum_finite": bool(np.isfinite(chk))}


def bench_scaling(k_steps: int = 8, dispatches: int = 6,
                  **overrides) -> dict:
    """Scaling-efficiency measurement for N≥2 devices (BASELINE.md
    target: ≥0.8 on 2+ hosts).  Times the COOPERATIVE time-sharded
    chain (ShardedBatchRunner: one pipeline over the mesh, halos/
    carries on collectives — network.c:810 stage-split analog) on 1
    device and on all devices.  The independent-streams fleet mode is
    reported alongside for comparison (it scales trivially).  With one
    device only the N=1 case runs."""
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    out = {"devices": len(devs), "mode": "cooperative_sharded_chain"}
    rng = np.random.default_rng(0)

    def run_sharded(devices):
        from linrad_tpu.parallel.sharded import ShardedBatchRunner
        d = len(devices)
        sb = ShardedBatchRunner(_params(**overrides), k_steps=k_steps,
                                outputs=("audio",), devices=devices)
        n = sb.geo.samples_per_step
        t = np.arange(n)
        sig = (np.exp(2j * np.pi * 0.13 * t)
               + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
               ).astype(np.complex64)
        from linrad_tpu.utils.xfer import device_complex
        blocks = jax.device_put(
            device_complex(np.broadcast_to(
                sig[None, :, None], (k_steps, n, 1)).copy()),
            sb._blocks_sharding)
        state = sb.state
        for _ in range(2):
            state, outs = sb._run_k(sb.tables, state, blocks,
                                    sb._tune_bin)
        jax.block_until_ready(outs)
        float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))  # warm fetch
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(dispatches):
                state, outs = sb._run_k(sb.tables, state, blocks,
                                        sb._tune_bin)
            float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))
            dt = time.perf_counter() - t0
            best = max(best, dispatches * k_steps * n / dt / 1e6)
        return best

    def run_fleet(devices):
        from linrad_tpu.parallel.fleet import FleetRunner
        d = len(devices)
        fl = FleetRunner(_params(**overrides), n_streams=d,
                         k_steps=k_steps, outputs=("audio",),
                         devices=devices)
        n = fl.geo.samples_per_step
        t = np.arange(n)
        sig = (np.exp(2j * np.pi * 0.13 * t)
               + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
               ).astype(np.complex64)
        from linrad_tpu.utils.xfer import device_complex
        blocks = device_complex(np.broadcast_to(
            sig[None, None, :, None], (k_steps, d, n, 1)).copy())
        blocks = jax.device_put(blocks, fl._stream_sharding)
        state = fl.state
        for _ in range(2):
            state, outs = fl._run_k(fl.tables, state, blocks,
                                    fl._tune_bins, fl._tune_fracs)
        jax.block_until_ready(outs)
        float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))  # warm fetch
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(dispatches):
                state, outs = fl._run_k(fl.tables, state, blocks,
                                        fl._tune_bins, fl._tune_fracs)
            float(np.asarray(jnp.sum(jnp.abs(outs[0][-1]))))
            dt = time.perf_counter() - t0
            best = max(best, dispatches * k_steps * n * d / dt / 1e6)
        return best

    out["msps_1dev"] = run_sharded(devs[:1])
    if len(devs) > 1:
        out["msps_all"] = run_sharded(devs)
        out["efficiency"] = (out["msps_all"]
                             / (out["msps_1dev"] * len(devs)))
        out["fleet_msps_all"] = run_fleet(devs)
        out["fleet_efficiency"] = (out["fleet_msps_all"]
                                   / (run_fleet(devs[:1]) * len(devs)))
    return out


def bench_batched_fetch(**kw) -> float:
    """bench_fetch_verified's Msps as a candidate-race entry."""
    r = bench_fetch_verified(**kw)
    LAST_WINDOWS[:] = [r["msps_fetch_verified"]]
    return float(r["msps_fetch_verified"])


# The candidate configurations; every window ends in a host fetch.
# Not yet measured on the GPU (PERF.md): the benchmark's fixed cells
# replace this race.
CANDIDATES = (
    (bench_stream_fetch, dict(steps=8, windows=3, blanker_rounds=0,
                              blanker_block_size=256,
                              max_pulses_per_block=256,
                              target_fft1_frames_per_step=2048)),
    (bench_stream_fetch, dict(steps=8, windows=3, blanker_rounds=0,
                              blanker_block_size=0,
                              max_pulses_per_block=64,
                              target_fft1_frames_per_step=2048)),
    (bench_stream_fetch, dict(steps=8, windows=3, blanker_rounds=0,
                              blanker_block_size=0,
                              max_pulses_per_block=128,
                              target_fft1_frames_per_step=1024)),
    (bench_stream_fetch, dict(steps=12, windows=3, blanker_rounds=0,
                              blanker_block_size=0,
                              max_pulses_per_block=32)),
    (bench_batched_fetch, dict(k_steps=4, dispatches=3,
                               blanker_rounds=0, blanker_block_size=0,
                               max_pulses_per_block=64,
                               target_fft1_frames_per_step=2048)),
)


def main():
    """Race the candidates, then the extras; one process, one device.

    Prints a JSON line after the race and an enriched one at the end
    (the last line is the result).  A device that fails fails the run:
    nothing is carried over from an earlier run."""
    from linrad_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    t_start = time.perf_counter()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    msps, win_fn, win_cfg, win_windows = 0.0, None, {}, []
    for fn, overrides in CANDIDATES:
        v = fn(**overrides)
        if v > msps:
            msps, win_fn, win_cfg = v, fn.__name__, overrides
            win_windows = list(LAST_WINDOWS)

    cache = {}
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            cache = json.load(f)
    shape_cfg = {k: v for k, v in win_cfg.items()
                 if k not in ("k_steps", "dispatches", "windows", "steps")}

    def ratios() -> dict:
        cpu_msps = cache.get("cpu_msamples_per_s")
        xl = cache.get("xlinrad_msps")
        vs_xl = round(msps / xl, 2) if xl else None
        return {
            # the honest baseline: the compiled reference chain itself
            "vs_baseline": vs_xl if vs_xl else (
                round(msps / cpu_msps, 2) if cpu_msps else None),
            "vs_xlinrad": vs_xl,
            "xlinrad_msps": round(xl, 3) if xl else None,
            "vs_numpy": round(msps / cpu_msps, 2) if cpu_msps else None,
        }

    report = {
        "metric": "complex Msamples/s/chip through fft1->blanker->fft2->demod",
        "value": round(msps, 2),
        "unit": "Msamples/s/chip",
        "device": device,
        **ratios(),
        **bench_roofline(msps, **shape_cfg),
        "config": {"fn": win_fn, **win_cfg},
        "windows_stats": window_stats(win_windows),
    }
    print(json.dumps(report), flush=True)

    report["fetch_verified"] = bench_fetch_verified(
        k_steps=4, dispatches=3, blanker_rounds=8,
        target_fft1_frames_per_step=2048, max_pulses_per_block=512)
    # sharding overhead: the cooperative sharded step on a 1-device mesh
    report["sharded_1dev_msps"] = round(bench_sharded_1dev(
        blanker_rounds=8, target_fft1_frames_per_step=2048,
        max_pulses_per_block=512), 2)

    # CPU baselines (cached after the first run)
    if "cpu_msamples_per_s" not in cache:
        cache["cpu_msamples_per_s"] = bench_cpu_reference()
    if "xlinrad_msps" not in cache:
        cache["xlinrad_msps"] = bench_xlinrad()
    with open(CACHE, "w") as f:
        json.dump(cache, f)
    report.update(ratios())

    report["scaling"] = (bench_scaling() if len(jax.devices()) > 1 else
                         {"devices": 1, "note": "efficiency needs >=2 "
                          "devices"})

    # bounded-latency mode (z_TIMING.txt 0.150 s budget)
    from linrad_tpu.pipeline.latency import latency_params, measure_latency
    report["latency"] = measure_latency(
        params=latency_params(second_fft=True), steps=60)
    report["elapsed_s"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
