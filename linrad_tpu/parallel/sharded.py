"""Time-block sharded pipeline step.

The wideband hot path (fft1 -> sellim split -> back-FFT -> blankers ->
fft2 -> mix1), which carries >95% of the FLOPs, is sharded along the
time axis: device d processes the d-th contiguous slice of each step's
samples.  Three kinds of cross-shard dependency exist, all nearest-
neighbour and all carried with ``lax.ppermute``:

1. **Framing halos**: overlapped analysis frames need the previous
   shard's tail samples (the fft1/fft2/fft3 interleave, the analog of
   Linrad's circular-buffer history, buf.c:303-327).
2. **Overlap-add carries**: inverse-transform reconstruction pushes
   partial sums into the next shard (timf2/timf3/baseband OLA).
3. **Global reductions**: power-spectrum averages and blanker noise
   floors are ``lax.pmean`` across shards (SURVEY.md §7).

The decimated narrowband finale (fft3/mix2/demod/AGC, ~1/decimation of
the samples) is computed replicated after an ``all_gather`` of the tiny
timf3 stream — its sequential AGC recurrence then needs no cross-shard
prefix fixup.  Linrad's equivalent is the single narrowband thread fed
by all fft1 workers (wcw.c:1240).

The per-stage DSP is the SAME code the single-chip chain runs:
``ops.fft1.fft1_step`` (with pmean'd power statistics) for the front
end and ``pipeline.chain.narrowband_post_mix1`` for everything after
mix1 — only the genuinely shard-aware parts (halo exchange, OLA carry
chains, blanker halos, the mix1 shard phase offset) live here.

Step-level carried state stays replicated (it is a few KB); each step
updates it from the last shard's values via a masked ``psum``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import Geometry
from ..params import RxParams
from ..ops import blanker as blanker_ops
from ..ops import sellim as sellim_ops
from ..ops.cplx import cdynamic_slice_in_dim
from ..ops.fft2 import FFT2State
from ..ops.framing import frame_stream, overlap_add
from ..ops.mix1 import Mix1State, mix1_step
from ..ops.fft1 import FFT1State, fft1_step
from ..ops.timf2 import Timf2State
from ..pipeline.chain import (NBState, RxOutputs, RxState, RxTables,
                              narrowband_post_mix1)

AXIS = "t"


def _from_left(x: jax.Array, axis_name: str = AXIS) -> jax.Array:
    """Value of ``x`` on the left neighbour (shard d-1); zeros on d=0."""
    d = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(d - 1)]
    return jax.lax.ppermute(x, axis_name, perm)


def _from_right(x: jax.Array, axis_name: str = AXIS) -> jax.Array:
    """Value of ``x`` on the right neighbour (shard d+1); zeros on the
    last shard."""
    d = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(d - 1)]
    return jax.lax.ppermute(x, axis_name, perm)


def _pick_last(x: jax.Array, axis_name: str = AXIS) -> jax.Array:
    """Broadcast the last shard's ``x`` to every shard (replicated)."""
    d = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    return jax.lax.psum(jnp.where(idx == d - 1, x, jnp.zeros_like(x)),
                        axis_name)


def _shard_tail(state_tail: jax.Array, local_block: jax.Array
                ) -> tuple[jax.Array, jax.Array]:
    """Per-shard framing tail: left neighbour's chunk end, or the carried
    state tail on shard 0.  Returns (tail_for_me, new_state_tail)."""
    ov = state_tail.shape[0]
    my_end = local_block[-ov:] if ov else local_block[:0]
    from_left = _from_left(my_end)
    idx = jax.lax.axis_index(AXIS)
    tail = jnp.where(idx == 0, state_tail, from_left)
    new_state_tail = _pick_last(my_end)
    return tail, new_state_tail


def _shard_ola(frames: jax.Array, hop: int, state_carry: jax.Array
               ) -> tuple[jax.Array, jax.Array]:
    """Sharded overlap-add: local OLA, then push the trailing partial
    sums into the right neighbour's head (carry chain)."""
    ov = state_carry.shape[0]
    zero = jnp.zeros_like(state_carry)
    out, carry = overlap_add(frames, hop, zero)
    incoming = _from_left(carry)
    idx = jax.lax.axis_index(AXIS)
    head_add = jnp.where(idx == 0, state_carry, incoming)
    out = out.at[:ov].add(head_add)
    new_state_carry = _pick_last(carry)
    return out, new_state_carry


def _make_sharded_front(geo: Geometry, p: RxParams, d: int,
                        blanker_pulsewidth: int):
    """Sharded fft1 -> sellim -> back-FFT -> blankers -> fft2 -> spur —
    the shard-aware twin of chain._make_wideband_front, reusing
    ``fft1_step``/``sellim``/``blanker`` kernels with halo exchange and
    OLA carry chains at the shard edges."""
    step_seconds = geo.samples_per_step / geo.timf1_sampling_speed
    n_fftx_local = (geo.fft2_frames_per_step if geo.second_fft_enable
                    else geo.fft1_frames_per_step) // d

    def front(tables: RxTables, state: RxState, block: jax.Array,
              tune0: jax.Array):
        # ---- fft1: shared kernel; tail comes from the left neighbour,
        # power statistics pmean across shards ----
        tail, new_tail = _shard_tail(state.fft1.tail, block)
        s1, spec, step_power = fft1_step(
            geo, tables.fft1,
            FFT1State(tail=tail, sumsq_avg=state.fft1.sumsq_avg),
            block, p.fft_avg1num, axis_name=AXIS)
        s_fft1 = FFT1State(tail=new_tail, sumsq_avg=s1.sumsq_avg)
        sumsq = s1.sumsq_avg

        s_sellim = state.sellim
        s_timf2 = state.timf2
        s_fft2 = state.fft2
        s_blank = state.blanker
        fft2_power = liminfo_out = nf_out = None
        n_fit = n_clear = None

        if geo.second_fft_enable:
            # protected passband (selfreq_liminfo, sellim.c:38-116)
            ratio = geo.fft2_size // geo.fft1_size
            sel_c = tune0 // ratio
            bw_bins = max(1, int(0.7 * (p.filter_high_hz - p.filter_low_hz)
                                 / geo.fft1_bandwidth)) + 3
            s_sellim = sellim_ops.update_liminfo(
                geo, state.sellim, jnp.sum(sumsq, axis=-1),
                p.sellim_maxlevel, ston=p.sellim_ston,
                sel_lo=sel_c - bw_bins,
                sel_hi=sel_c + bw_bins)
            wgain, sgain = sellim_ops.liminfo_gains(s_sellim.liminfo)
            # back transform local frames; OLA with carry chain
            gains = jnp.stack([wgain, sgain])
            masked = spec[None] * gains[:, None, :, None]
            back = jnp.fft.ifft(masked, axis=2)
            bframes = back * tables.timf2_syn[None, None, :, None]
            weak, wc = _shard_ola(bframes[0], geo.fft1_new_points,
                                  state.timf2.weak_carry)
            strong, sc = _shard_ola(bframes[1], geo.fft1_new_points,
                                    state.timf2.strong_carry)
            s_timf2 = Timf2State(weak_carry=wc, strong_carry=sc)
            wpwr = jnp.sum(jnp.real(weak) ** 2 + jnp.imag(weak) ** 2,
                           axis=-1)
            nf = state.blanker.noise_floor
            n_fit = jnp.int32(0)
            n_clear = jnp.int32(0)
            # floor tracked from PRE-blank power (matches chain.py: the
            # despiked mean rejects pulses; post-blank tracking feeds
            # back through the cleared zeros)
            mean = jax.lax.pmean(blanker_ops.despiked_mean(wpwr), AXIS)
            a_nf = jnp.float32(min(1.0, step_seconds))
            s_blank = blanker_ops.BlankerState(
                noise_floor=jnp.maximum(
                    nf * (1 - a_nf) + mean * a_nf, 1e-20))
            if p.blanker_enable:
                # clever blanker with cross-shard halos: each shard sees
                # one fit-window of neighbour samples so boundary pulses
                # are fitted whole; candidate *centres* stay shard-owned
                # (eligible mask), and the corrections a fit writes into
                # neighbour territory are shipped back and
                # applied (subtractions are linear, so they compose)
                halo = tables.blanker.refbank.shape[1]
                ext_w = jnp.concatenate(
                    [_from_left(weak[-halo:]), weak,
                     _from_right(weak[:halo])])
                ext_p = jnp.concatenate(
                    [_from_left(wpwr[-halo:]), wpwr,
                     _from_right(wpwr[:halo])])
                n_local = weak.shape[0]
                elig = jnp.pad(jnp.ones(n_local, bool), (halo, halo))
                ext_w0_l = ext_w[:halo]
                ext_w0_r = ext_w[-halo:]
                ext_w, ext_p, n_fit = blanker_ops.clever_blanker(
                    ext_w, ext_p, tables.blanker, nf, p.clever_bln_limit,
                    blanker_pulsewidth,
                    max(1, p.max_pulses_per_block // d),
                    block_size=p.blanker_block_size,
                    rounds=p.blanker_rounds, eligible=elig)
                weak = ext_w[halo: halo + n_local]
                # ship halo corrections to their owners and re-derive
                # the power over the touched edges
                dl = ext_w[:halo] - ext_w0_l          # belongs left
                dr = ext_w[-halo:] - ext_w0_r         # belongs right
                add_r = _from_right(dl)               # my tail samples
                add_l = _from_left(dr)                # my head samples
                weak = weak.at[-halo:].add(add_r)
                weak = weak.at[:halo].add(add_l)
                wpwr = jnp.sum(jnp.real(weak) ** 2 + jnp.imag(weak) ** 2,
                               axis=-1)
                # stupid blanker on the halo-extended stream: its
                # widening reach is ≤ pulsewidth+1 < halo, so runs that
                # cross a shard edge widen exactly as on one device
                # (read-only halos, own region sliced back out)
                sw = jnp.concatenate(
                    [_from_left(weak[-halo:]), weak,
                     _from_right(weak[:halo])])
                sp = jnp.concatenate(
                    [_from_left(wpwr[-halo:]), wpwr,
                     _from_right(wpwr[:halo])])
                sw2, sp2, _ = blanker_ops.stupid_blanker(
                    sw, sp, nf, p.stupid_bln_limit, blanker_pulsewidth)
                pre = wpwr
                weak = sw2[halo: halo + n_local]
                wpwr = sp2[halo: halo + n_local]
                n_clear = jnp.sum(((wpwr == 0.0) & (pre > 0.0))
                                  .astype(jnp.int32))
                n_fit = jax.lax.psum(n_fit, AXIS)
                n_clear = jax.lax.psum(n_clear, AXIS)
            nf_out = s_blank.noise_floor
            # fft2 framing over the sharded timf2 stream
            timf2 = weak + strong
            tail2, new_tail2 = _shard_tail(state.fft2.tail, timf2)
            f2, _ = frame_stream(tail2, timf2, geo.fft2_size,
                                 geo.fft2_new_points)
            fftx_spec = jnp.fft.fft(
                f2 * tables.fft2.window[None, :, None], axis=1)
            # spur cancellation BEFORE the power spectrum, as the
            # single-chip chain / reference (fft2.c:648-670); replicated
            # over gathered spectra (the per-frame model recurrence
            # chains across shard boundaries; spectra small, ~1 MB)
            s_spur = state.spur
            if p.spur_enable:
                from ..weak.spur import spur_subtract_step
                full_spec = jax.lax.all_gather(fftx_spec, AXIS, axis=0,
                                               tiled=True)
                s_spur, full_clean = spur_subtract_step(
                    geo, tables.spur_template, state.spur, full_spec)
                fftx_spec = cdynamic_slice_in_dim(
                    full_clean, jax.lax.axis_index(AXIS) * n_fftx_local,
                    n_fftx_local, 0)
            pwr2 = jnp.real(fftx_spec) ** 2 + jnp.imag(fftx_spec) ** 2
            fft2_power = jax.lax.pmean(jnp.mean(pwr2, axis=0), AXIS)
            a2 = min(1.0, geo.fft2_frames_per_step / max(p.fft_avg1num, 1))
            s_fft2 = FFT2State(
                tail=new_tail2,
                sumsq_avg=state.fft2.sumsq_avg * (1 - a2) + fft2_power * a2)
            liminfo_out = s_sellim.liminfo
        else:
            fftx_spec = spec
            s_spur = state.spur
            if p.spur_enable:
                from ..weak.spur import spur_subtract_step
                full_spec = jax.lax.all_gather(fftx_spec, AXIS, axis=0,
                                               tiled=True)
                s_spur, full_clean = spur_subtract_step(
                    geo, tables.spur_template, state.spur, full_spec)
                fftx_spec = cdynamic_slice_in_dim(
                    full_clean, jax.lax.axis_index(AXIS) * n_fftx_local,
                    n_fftx_local, 0)

        wide = dict(fft1=s_fft1, sellim=s_sellim, timf2=s_timf2,
                    fft2=s_fft2, blanker=s_blank, spur=s_spur)
        aux = dict(step_power=step_power, fft2_power=fft2_power,
                   liminfo=liminfo_out, blanker_fitted=n_fit,
                   blanker_cleared=n_clear, noise_floor=nf_out,
                   sumsq=sumsq)
        return wide, fftx_spec, aux

    return front, n_fftx_local


def _sharded_mix1(geo: Geometry, tables: RxTables, state_mix1: Mix1State,
                  fftx_spec: jax.Array, tune_bin: jax.Array,
                  per_frame_tune: bool, n_fftx_local: int,
                  tune_frac: jax.Array | None = None,
                  tune_slope: jax.Array | None = None
                  ) -> tuple[Mix1State, jax.Array]:
    """mix1 over sharded fftx frames: each shard runs the shared
    ``mix1_step`` from a phase offset equal to the wrapped sum of all
    earlier shards' increments, then the timf3 OLA carries chain into
    the right neighbour and the decimated stream is all_gathered.

    tune_frac/tune_slope: (n_local,) frame-sharded coherent-AFC ramps
    (mix1.c:648); each shard's fractional-phase origin is the exclusive
    prefix of the per-shard frac advances (the slope term sums to zero
    within every frame, so only frac contributes across shards).

    Returns (new_replicated_mix1_state, full_timf3)."""
    idx = jax.lax.axis_index(AXIS)
    big_n = geo.fftx_size
    mask = jnp.uint32(big_n - 1)
    hop32 = jnp.uint32(geo.fftx_new_points)
    if per_frame_tune:
        # tune_bin: (n_local,) — exclusive prefix of per-shard
        # increment sums gives each shard's phase offset
        local_incr_sum = jnp.sum(
            (tune_bin.astype(jnp.uint32) * hop32) & mask)
        sums = jax.lax.all_gather(local_incr_sum, AXIS)   # (D,)
        before = jnp.sum(jnp.where(
            jnp.arange(sums.shape[0]) < idx, sums, jnp.uint32(0)))
        shard_phase = (state_mix1.phase_idx.astype(jnp.uint32)
                       + before) & mask
    else:
        incr = (tune_bin.astype(jnp.uint32) * hop32) & mask
        shard_phase = (state_mix1.phase_idx.astype(jnp.uint32)
                       + incr * (idx.astype(jnp.uint32)
                                 * jnp.uint32(n_fftx_local))) & mask
    shard_frac = state_mix1.frac_phase
    if tune_frac is not None:
        # per-shard fractional-phase advance, in turns: each frame adds
        # hop_m samples at frac/m turns per sample (mix1_step's ramp)
        adv = jnp.sum(jnp.asarray(tune_frac, jnp.float32)) \
            * (geo.mix1_new_points / geo.mix1_size)
        advs = jax.lax.all_gather(adv, AXIS)              # (D,)
        before_f = jnp.sum(jnp.where(
            jnp.arange(advs.shape[0]) < idx, advs, 0.0))
        shard_frac = jnp.mod(state_mix1.frac_phase + before_f, 1.0)
    local_state = Mix1State(
        phase_idx=shard_phase.astype(jnp.int32),
        ola_carry=jnp.zeros_like(state_mix1.ola_carry),
        frac_phase=shard_frac)
    m1, timf3_local = mix1_step(geo, tables.mix1, local_state,
                                fftx_spec, tune_bin,
                                tune_frac=tune_frac,
                                tune_slope=tune_slope)
    # OLA carry chain for timf3
    ov3 = geo.mix1_interleave_points
    incoming = _from_left(m1.ola_carry)
    head = jnp.where(idx == 0, state_mix1.ola_carry, incoming)
    if tune_frac is not None:
        # mix1_step ramps the OLA'd output; the neighbour's carry is
        # raw, so apply this shard's output ramp to it before adding
        from ..ops.mix1 import frac_ramp
        ramp, _ = frac_ramp(geo, shard_frac, tune_frac, tune_slope,
                            int(fftx_spec.shape[0]))
        head = head * ramp[:ov3, None]
    timf3_local = timf3_local.at[:ov3].add(head)
    new_state = Mix1State(phase_idx=_pick_last(m1.phase_idx),
                          ola_carry=_pick_last(m1.ola_carry),
                          frac_phase=_pick_last(m1.frac_phase))
    timf3 = jax.lax.all_gather(timf3_local, AXIS, axis=0, tiled=True)
    return new_state, timf3


def _fir_len(tables: RxTables) -> int:
    return (int(tables.mix2.fir.shape[0])
            if tables.mix2.fir is not None else 0)


def make_sharded_rx_step(geo: Geometry, p: RxParams, mesh: Mesh,
                         blanker_pulsewidth: int = 2,
                         per_frame_tune: bool = False,
                         coherent_tune: bool = False,
                         tables: RxTables | None = None):
    """Build the sharded step.  Requires every per-shard chunk to hold an
    integer number of frames at every stage — derive the geometry with
    ``RxParams(shards=<mesh size>)``.

    With ``per_frame_tune`` the tune argument is a (fftx_frames_per_step,)
    array sharded along frames (the AFC mix1_fq_mid path); the mixer
    phase offset of each shard is the wrapped sum of all earlier shards'
    increments (exclusive prefix over the gathered per-shard sums).

    With ``coherent_tune`` the step additionally takes frame-sharded
    (tune_frac, tune_slope) float32 arrays — the coherent drift-tracking
    form (do_mix1_afc mix1.c:648): the signature becomes
    ``step(tables, state, block, tune_bin, tune_frac, tune_slope)``."""
    d = mesh.shape[AXIS]
    assert geo.fft1_frames_per_step % d == 0, (
        f"fft1 frames {geo.fft1_frames_per_step} not divisible by mesh "
        f"size {d}; set RxParams(shards={d})")
    if geo.second_fft_enable:
        assert geo.fft2_frames_per_step % d == 0
    assert geo.fft3_frames_per_step % d == 0
    front, n_fftx_local = _make_sharded_front(geo, p, d,
                                              blanker_pulsewidth)
    tables0 = tables if tables is not None else RxTables.create(geo, p)
    fir_len = _fir_len(tables0) if p.mixer_mode == 2 else 0

    def shard_body(tables: RxTables, state: RxState, block: jax.Array,
                   tune_bin: jax.Array,
                   tune_frac: jax.Array | None = None,
                   tune_slope: jax.Array | None = None):
        if per_frame_tune or coherent_tune:
            # global first frame's bin (shard 0's first element)
            tune0 = jax.lax.psum(
                jnp.where(jax.lax.axis_index(AXIS) == 0,
                          jnp.reshape(tune_bin, (-1,))[0], 0),
                AXIS)
        else:
            tune0 = tune_bin
        wide, fftx_spec, aux = front(tables, state, block, tune0)
        new_mix1, timf3 = _sharded_mix1(geo, tables, state.mix1,
                                        fftx_spec, tune_bin,
                                        per_frame_tune or coherent_tune,
                                        n_fftx_local,
                                        tune_frac=tune_frac,
                                        tune_slope=tune_slope)
        # ---- narrowband finale: replicated, shared with the single-chip
        # chain (it is 1/decimation of the data) ----
        nb, audio, baseb, gain = narrowband_post_mix1(
            geo, p, tables, NBState.from_rx(state), new_mix1, timf3)
        new_state = RxState(fft1=wide["fft1"], mix1=nb.mix1,
                            fft3=nb.fft3, mix2=nb.mix2, bfo=nb.bfo,
                            am=nb.am, fm=nb.fm, coh=nb.coh, agc=nb.agc,
                            sellim=wide["sellim"], timf2=wide["timf2"],
                            fft2=wide["fft2"], blanker=wide["blanker"],
                            spur=wide["spur"], squelch=nb.squelch,
                            pol=nb.pol, mix2_fir=nb.mix2_fir)
        outputs = RxOutputs(audio=audio, baseb=baseb,
                            fft1_power=aux["step_power"],
                            fft1_avg_power=aux["sumsq"],
                            agc_gain=gain, fft2_power=aux["fft2_power"],
                            liminfo=aux["liminfo"],
                            blanker_fitted=aux["blanker_fitted"],
                            blanker_cleared=aux["blanker_cleared"],
                            noise_floor=aux["noise_floor"])
        return new_state, outputs

    # everything except the input block is replicated; the block is
    # sharded along time
    state0 = RxState.create(geo, spur=p.spur_enable,
                            pol=p.pol_adapt_enable, fir_len=fir_len)
    state_spec = jax.tree_util.tree_map(lambda _: P(), state0)
    tables_spec = jax.tree_util.tree_map(lambda _: P(), tables0)
    out_spec = jax.tree_util.tree_map(
        lambda _: P(), (state0, _outputs_struct(geo, p)))

    tune_spec = P(AXIS) if (per_frame_tune or coherent_tune) else P()
    in_specs = (tables_spec, state_spec, P(AXIS, None), tune_spec)
    if coherent_tune:
        in_specs = in_specs + (P(AXIS), P(AXIS))
    sharded = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec, check_vma=False)
    return sharded


def make_sharded_multi_rx_step(geo: Geometry, p: RxParams, mesh: Mesh,
                               n_subch: int, blanker_pulsewidth: int = 2,
                               tables: RxTables | None = None):
    """Sharded twin of chain.make_multi_rx_step: ONE sharded wideband
    front end feeding K independently tuned narrowband sub-receivers
    (the reference's network userx consumers, globdef.h:1282-1294,
    served from one master's wideband stream).

    The K tails are a vmapped batch axis over (sharded mix1 + replicated
    post-mix1 finale); collectives vectorise over the vmap axis, so the
    halo/gather traffic is batched across sub-receivers.

    Returns ``step(tables, state, nbs, block, tune_bins) ->
    ((state, nbs), outputs)`` matching the single-chip multi step."""
    d = mesh.shape[AXIS]
    assert geo.fft1_frames_per_step % d == 0
    if geo.second_fft_enable:
        assert geo.fft2_frames_per_step % d == 0
    front, n_fftx_local = _make_sharded_front(geo, p, d,
                                              blanker_pulsewidth)
    tables0 = tables if tables is not None else RxTables.create(geo, p)
    fir_len = _fir_len(tables0) if p.mixer_mode == 2 else 0

    def shard_body(tables: RxTables, state: RxState, nbs: NBState,
                   block: jax.Array, tune_bins: jax.Array):
        tune0 = jnp.reshape(tune_bins, (-1,))[0]
        wide, fftx_spec, aux = front(tables, state, block, tune0)

        def one_sub(nb, tune):
            m1, timf3 = _sharded_mix1(geo, tables, nb.mix1, fftx_spec,
                                      tune, False, n_fftx_local)
            return narrowband_post_mix1(geo, p, tables, nb, m1, timf3)

        nbs_out, audio, baseb, gain = jax.vmap(
            one_sub, in_axes=(0, 0))(nbs, tune_bins)
        new_state = RxState(fft1=wide["fft1"], mix1=state.mix1,
                            fft3=state.fft3, mix2=state.mix2,
                            bfo=state.bfo, am=state.am, fm=state.fm,
                            coh=state.coh, agc=state.agc,
                            sellim=wide["sellim"], timf2=wide["timf2"],
                            fft2=wide["fft2"], blanker=wide["blanker"],
                            spur=wide["spur"], squelch=state.squelch,
                            pol=state.pol, mix2_fir=state.mix2_fir)
        outputs = RxOutputs(audio=audio, baseb=baseb,
                            fft1_power=aux["step_power"],
                            fft1_avg_power=aux["sumsq"],
                            agc_gain=gain, fft2_power=aux["fft2_power"],
                            liminfo=aux["liminfo"],
                            blanker_fitted=aux["blanker_fitted"],
                            blanker_cleared=aux["blanker_cleared"],
                            noise_floor=aux["noise_floor"])
        return (new_state, nbs_out), outputs

    state0 = RxState.create(geo, spur=p.spur_enable, fir_len=fir_len)
    nbs0 = NBState.create_stacked(geo, n_subch,
                                  pol=p.pol_adapt_enable,
                                  fir_len=fir_len)
    state_spec = jax.tree_util.tree_map(lambda _: P(), state0)
    nbs_spec = jax.tree_util.tree_map(lambda _: P(), nbs0)
    tables_spec = jax.tree_util.tree_map(lambda _: P(), tables0)
    out_spec = jax.tree_util.tree_map(
        lambda _: P(), ((state0, nbs0), _outputs_struct(geo, p)))
    sharded = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(tables_spec, state_spec, nbs_spec, P(AXIS, None), P()),
        out_specs=out_spec, check_vma=False)
    return sharded


def _outputs_struct(geo: Geometry, p: RxParams):
    """Zero-filled RxOutputs with the right tree structure for specs."""
    wide = geo.second_fft_enable
    z = jnp.zeros(())
    return RxOutputs(
        audio=z, baseb=z, fft1_power=z, fft1_avg_power=z, agc_gain=z,
        fft2_power=z if wide else None,
        liminfo=z if wide else None,
        blanker_fitted=z if wide else None,
        blanker_cleared=z if wide else None,
        noise_floor=z if wide else None)


class ShardedReceiver:
    """Receiver running one pipeline over a device mesh.

    The host feeds full step blocks; jax shards them along time.  This is
    the single-pipeline scale-out mode (Linrad master+slaves on one
    signal, z_NETWORK.txt); for throughput over independent recordings
    use one Receiver per device instead."""

    def __init__(self, params: RxParams, devices=None,
                 calibration: dict | None = None):
        from ..geometry import derive_geometry
        if devices is None:
            devices = jax.devices()
        self.mesh = Mesh(np.array(devices), (AXIS,))
        d = len(devices)
        if params.shards != d:
            params = RxParams(**{**params.__dict__, "shards": d})
        self.params = params
        self.geo = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, calibration)
        self.state = RxState.create(
            self.geo, spur=params.spur_enable,
            pol=params.pol_adapt_enable,
            fir_len=_fir_len(self.tables))
        pw = 2
        if self.geo.second_fft_enable:
            from ..ops.blanker import BlankerTables
            _, pw = BlankerTables.create(self.geo)
        self._step = jax.jit(
            make_sharded_rx_step(self.geo, params, self.mesh, pw,
                                 tables=self.tables))
        # AFC path: separate compilation with a per-frame-sharded tune
        self._step_afc = jax.jit(
            make_sharded_rx_step(self.geo, params, self.mesh, pw,
                                 per_frame_tune=True, tables=self.tables))
        # coherent AFC path: frame-sharded (bins, frac, slope)
        self._step_coh = jax.jit(
            make_sharded_rx_step(self.geo, params, self.mesh, pw,
                                 coherent_tune=True, tables=self.tables))
        self._tune_bin = jnp.zeros((), jnp.int32)
        self._tune_frac = jnp.zeros((), jnp.float32)
        self._tune_slope = None
        self._block_sharding = NamedSharding(self.mesh, P(AXIS, None))
        self._tune_sharding = NamedSharding(self.mesh, P(AXIS))
        from ..pipeline.control import WeakSignalControl
        self.control = WeakSignalControl(self.geo, params)

    def tune(self, freq_hz: float) -> None:
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune_bin = jnp.asarray(
            int(round(freq_hz / fs * n)) % n, jnp.int32)
        self._tune_frac = jnp.zeros((), jnp.float32)
        self._tune_slope = None
        self.control.on_tune(freq_hz)

    def process_block(self, block) -> RxOutputs:
        from ..utils.xfer import device_complex
        block = (device_complex(block) if self.geo.iq_input
                 else jnp.asarray(block, jnp.float32))
        if block.ndim == 1:
            block = block[:, None]
        block = jax.device_put(block, self._block_sharding)
        if self._tune_slope is not None:  # coherent AFC drift tracking
            tune = jax.device_put(self._tune_bin, self._tune_sharding)
            frac = jax.device_put(self._tune_frac, self._tune_sharding)
            slope = jax.device_put(self._tune_slope,
                                   self._tune_sharding)
            self.state, out = self._step_coh(self.tables, self.state,
                                             block, tune, frac, slope)
        elif self._tune_bin.ndim:  # per-frame AFC tuning
            tune = jax.device_put(self._tune_bin, self._tune_sharding)
            self.state, out = self._step_afc(self.tables, self.state,
                                             block, tune)
        else:
            self.state, out = self._step(self.tables, self.state, block,
                                         self._tune_bin)
        (self._tune_bin, self._tune_frac, self._tune_slope,
         self.state) = self.control.update(
            out, self._tune_bin, self.state,
            tune_frac=self._tune_frac, tune_slope=self._tune_slope)
        return out

    def run(self, iq: np.ndarray):
        if iq.ndim == 1:
            iq = iq[:, None]
        s = self.geo.samples_per_step
        if not self.geo.iq_input:
            s *= 2
        for i in range(iq.shape[0] // s):
            yield self.process_block(iq[i * s:(i + 1) * s])


class ShardedMultiReceiver:
    """K independently tuned sub-receivers over ONE sharded wideband
    front end — the mesh twin of pipeline.receiver.MultiReceiver
    (reference userx consumers, globdef.h:1282-1294)."""

    def __init__(self, params: RxParams, n_subch: int, devices=None,
                 calibration: dict | None = None):
        from ..geometry import derive_geometry
        if devices is None:
            devices = jax.devices()
        self.mesh = Mesh(np.array(devices), (AXIS,))
        d = len(devices)
        if params.shards != d:
            params = RxParams(**{**params.__dict__, "shards": d})
        self.params = params
        self.n_subch = n_subch
        self.geo = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, calibration)
        fir_len = _fir_len(self.tables)
        self.state = RxState.create(self.geo, spur=params.spur_enable,
                                    fir_len=fir_len)
        self.nbs = NBState.create_stacked(
            self.geo, n_subch, pol=params.pol_adapt_enable,
            fir_len=fir_len)
        pw = 2
        if self.geo.second_fft_enable:
            from ..ops.blanker import BlankerTables
            _, pw = BlankerTables.create(self.geo)
        self._step = jax.jit(make_sharded_multi_rx_step(
            self.geo, params, self.mesh, n_subch, pw,
            tables=self.tables))
        self._tune_bins = np.zeros(n_subch, np.int64)
        self._block_sharding = NamedSharding(self.mesh, P(AXIS, None))

    def tune_subch(self, k: int, freq_hz: float) -> None:
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune_bins[k] = int(round(freq_hz / fs * n)) % n

    def process_block(self, block) -> RxOutputs:
        from ..utils.xfer import device_complex
        block = (device_complex(block) if self.geo.iq_input
                 else jnp.asarray(block, jnp.float32))
        if block.ndim == 1:
            block = block[:, None]
        block = jax.device_put(block, self._block_sharding)
        (self.state, self.nbs), out = self._step(
            self.tables, self.state, self.nbs, block,
            jnp.asarray(self._tune_bins, jnp.int32))
        return out

    def run(self, iq: np.ndarray):
        if iq.ndim == 1:
            iq = iq[:, None]
        s = self.geo.samples_per_step
        if not self.geo.iq_input:
            s *= 2
        for i in range(iq.shape[0] // s):
            yield self.process_block(iq[i * s:(i + 1) * s])


class ShardedBatchRunner:
    """Throughput mode over the mesh: K sharded steps per dispatch.

    The lax.scan of pipeline/batch.py wrapped around the shard_map step —
    the device mesh processes K * samples_per_step samples per dispatch
    with the cross-shard halos/carries on collectives inside the scan and no
    host round-trips in between.  State chains through the scan exactly
    as across streamed ShardedReceiver steps (tested)."""

    def __init__(self, params: RxParams, k_steps: int = 16,
                 outputs: tuple = ("audio", "baseb"), devices=None,
                 calibration: dict | None = None):
        from ..geometry import derive_geometry
        if devices is None:
            devices = jax.devices()
        self.mesh = Mesh(np.array(devices), (AXIS,))
        d = len(devices)
        if params.shards != d:
            params = RxParams(**{**params.__dict__, "shards": d})
        self.params = params
        self.geo = derive_geometry(params)
        self.k = k_steps
        self.outputs = tuple(outputs)
        self.tables = RxTables.create(self.geo, params, calibration)
        self.state = RxState.create(
            self.geo, spur=params.spur_enable,
            pol=params.pol_adapt_enable,
            fir_len=_fir_len(self.tables))
        pw = 2
        if self.geo.second_fft_enable:
            from ..ops.blanker import BlankerTables
            _, pw = BlankerTables.create(self.geo)
        step = make_sharded_rx_step(self.geo, params, self.mesh, pw)
        fields = self.outputs

        def run_k(tables, state, blocks, tune_bin):
            def body(s, blk):
                s, out = step(tables, s, blk, tune_bin)
                return s, tuple(getattr(out, f) for f in fields)

            return jax.lax.scan(body, state, blocks)

        self._run_k = jax.jit(run_k, donate_argnums=(1,))
        self._tune_bin = jnp.zeros((), jnp.int32)
        self._blocks_sharding = NamedSharding(self.mesh, P(None, AXIS,
                                                           None))

    def tune(self, freq_hz: float) -> None:
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune_bin = jnp.asarray(
            int(round(freq_hz / fs * n)) % n, jnp.int32)

    @property
    def samples_per_call(self) -> int:
        return self.k * self.geo.samples_per_step

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """Process a recording; returns concatenated output streams.
        Trailing samples short of a full K-step call are dropped."""
        if iq.ndim == 1:
            iq = iq[:, None]
        s = self.geo.samples_per_step
        per = self.samples_per_call
        collected: dict[str, list] = {f: [] for f in self.outputs}
        for i in range(iq.shape[0] // per):
            from ..utils.xfer import device_complex
            seg = device_complex(iq[i * per:(i + 1) * per])
            blocks = jax.device_put(
                seg.reshape(self.k, s, self.geo.channels),
                self._blocks_sharding)
            self.state, outs = self._run_k(self.tables, self.state,
                                           blocks, self._tune_bin)
            for f, v in zip(self.outputs, outs):
                a = np.asarray(v)               # (K, S_f, C)
                collected[f].append(a.reshape(-1, a.shape[-1]))
        return {f: (np.concatenate(v) if v else np.zeros((0, 1)))
                for f, v in collected.items()}
