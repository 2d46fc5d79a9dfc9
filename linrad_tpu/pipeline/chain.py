"""The jitted signal chain: one pipeline step.

Linrad's 57-thread pipeline (input -> wideband_dsp -> timf2 -> second_fft
-> narrowband_dsp -> mix2 -> fft3 -> rx_output, reference
menu.c:700-721 / SURVEY.md §3.3-3.4) collapses into ONE pure function:

    state, outputs = rx_step(state, iq_block, tune_bin)

Thread hand-offs become function composition; circular buffers become the
carried ``RxState`` pytree; events/semaphores vanish (XLA's dataflow *is*
the synchronisation).  Everything inside is static-shaped, so the whole
chain compiles to a single fused XLA program per configuration.

With the second FFT enabled the wideband branch runs between fft1 and
mix1: sellim classification -> weak/strong back transform -> noise
blankers -> fft2, and the narrowband chain consumes fft2 transforms
(the fft1/fft2 store boundary of fft1def.h:242-330).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..params import Demod, RxParams
from ..utils.pytree import pytree_dataclass
from ..ops import agc as agc_ops
from ..ops import demod as demod_ops
from ..ops import blanker as blanker_ops
from ..ops import sellim as sellim_ops
from ..ops.blanker import BlankerState, BlankerTables
from ..ops.fft1 import FFT1State, FFT1Tables, fft1_step
from ..ops.fft2 import FFT2State, FFT2Tables, fft2_step
from ..ops.fft3 import FFT3State, FFT3Tables, fft3_step
from ..ops.mix1 import Mix1State, Mix1Tables, mix1_step
from ..ops.mix2 import (Mix2FirState, Mix2State, Mix2Tables,
                        mix2_carrier_step, mix2_fir_step, mix2_step)
from ..ops.sellim import SellimState
from ..ops.squelch import SquelchState, expander, squelch_step
from ..ops.timf2 import Timf2State, make_timf2_syn, timf2_step
from ..weak.pol import PolState, update_polarization
from ..weak.spur import (SpurState, spur_subtract_step,
                         window_template_table)


@pytree_dataclass(frozen=True)
class RxTables:
    fft1: FFT1Tables
    mix1: Mix1Tables
    fft3: FFT3Tables
    mix2: Mix2Tables
    fft2: FFT2Tables | None
    timf2_syn: jax.Array | None
    blanker: BlankerTables | None
    spur_template: jax.Array | None

    @classmethod
    def create(cls, geo: Geometry, p: RxParams,
               calibration: dict | None = None) -> "RxTables":
        calibration = calibration or {}
        fft2 = timf2_syn = blanker = spur_tpl = None
        if geo.second_fft_enable:
            fft2 = FFT2Tables.create(geo)
            timf2_syn = make_timf2_syn(geo)
            blanker, _pw = BlankerTables.create(geo)
        if p.spur_enable:
            sinpow = (geo.fft2_sinpow if geo.second_fft_enable
                      else geo.fft1_sinpow)
            from ..utils.xfer import device_complex
            spur_tpl = device_complex(
                window_template_table(geo.fftx_size, sinpow))
        return cls(fft1=FFT1Tables.create(
                       geo, filtercorr=calibration.get("filtercorr"),
                       iq_corr=calibration.get("iq_corr")),
                   mix1=Mix1Tables.create(geo),
                   fft3=FFT3Tables.create(geo),
                   mix2=Mix2Tables.create(geo, p),
                   fft2=fft2, timf2_syn=timf2_syn, blanker=blanker,
                   spur_template=spur_tpl)


@pytree_dataclass
class RxState:
    fft1: FFT1State
    mix1: Mix1State
    fft3: FFT3State
    mix2: Mix2State
    bfo: demod_ops.BFOState
    am: demod_ops.AMState
    fm: demod_ops.FMState
    coh: demod_ops.CoherentState
    agc: agc_ops.AGCState
    sellim: SellimState | None
    timf2: Timf2State | None
    fft2: FFT2State | None
    blanker: BlankerState | None
    spur: SpurState | None = None
    squelch: SquelchState | None = None
    pol: PolState | None = None
    mix2_fir: Mix2FirState | None = None  # mixer_mode-2 timf3 history

    @classmethod
    def create(cls, geo: Geometry, spur: bool = False,
               pol: bool = False, fir_len: int = 0,
               audio_channels: int | None = None) -> "RxState":
        # adaptive polarization combines the 2 channels into 1 before
        # the detectors, so the demod/AGC state is single-channel then;
        # coherent mode 1 doubles it (signal ear + carrier ear)
        c = audio_channels or (1 if pol else geo.channels)
        wide = geo.second_fft_enable
        return cls(
            spur=SpurState.create(geo) if spur else None,
            squelch=SquelchState.create(),
            pol=PolState.create() if pol else None,
            fft1=FFT1State.create(geo),
            mix1=Mix1State.create(geo),
            fft3=FFT3State.create(geo),
            mix2=Mix2State.create(geo),
            bfo=demod_ops.BFOState.create(),
            am=demod_ops.AMState.create(c),
            fm=demod_ops.FMState.create(c),
            coh=demod_ops.CoherentState.create(c),
            agc=agc_ops.AGCState.create(c),
            sellim=SellimState.create(geo) if wide else None,
            timf2=Timf2State.create(geo) if wide else None,
            fft2=FFT2State.create(geo) if wide else None,
            blanker=BlankerState.create(geo) if wide else None,
            mix2_fir=(Mix2FirState.create(geo, fir_len) if fir_len
                      else None),
        )


@pytree_dataclass
class RxOutputs:
    """Per-step observable outputs — the stage-tap set of the
    reference's network layer (RAW/FFT1/TIMF2/FFT2/BASEB,
    globdef.h:237-253) as pipeline outputs."""

    audio: jax.Array          # (S_audio, C) float32 demodulated audio
    baseb: jax.Array          # (S_bb, C) complex64 filtered baseband
    fft1_power: jax.Array     # (fft1_size, C) float32 step power spectrum
    fft1_avg_power: jax.Array  # slow average (fft1_sumsq analog)
    agc_gain: jax.Array       # (S_bb, C) float32
    fft2_power: jax.Array | None      # (fft2_size, C) float32
    liminfo: jax.Array | None         # (fft1_size,) float32
    blanker_fitted: jax.Array | None  # () int32 pulses subtracted
    blanker_cleared: jax.Array | None  # () int32 points hard-cleared
    noise_floor: jax.Array | None     # () float32


@pytree_dataclass
class NBState:
    """Narrowband state of ONE sub-receiver (one mix1 channel of the
    reference's MIX1_NO_OF_CHANNELS=24 slots, globdef.h:315)."""

    mix1: Mix1State
    fft3: FFT3State
    mix2: Mix2State
    bfo: demod_ops.BFOState
    am: demod_ops.AMState
    fm: demod_ops.FMState
    coh: demod_ops.CoherentState
    agc: agc_ops.AGCState
    squelch: SquelchState | None = None
    pol: PolState | None = None
    mix2_fir: Mix2FirState | None = None

    @classmethod
    def create(cls, geo: Geometry, pol: bool = False,
               fir_len: int = 0,
               audio_channels: int | None = None) -> "NBState":
        c = audio_channels or (1 if pol else geo.channels)
        return cls(
            mix1=Mix1State.create(geo), fft3=FFT3State.create(geo),
            mix2=Mix2State.create(geo), bfo=demod_ops.BFOState.create(),
            am=demod_ops.AMState.create(c), fm=demod_ops.FMState.create(c),
            coh=demod_ops.CoherentState.create(c),
            agc=agc_ops.AGCState.create(c),
            squelch=SquelchState.create(),
            pol=PolState.create() if pol else None,
            mix2_fir=(Mix2FirState.create(geo, fir_len) if fir_len
                      else None))

    @classmethod
    def create_stacked(cls, geo: Geometry, n_subch: int,
                       pol: bool = False, fir_len: int = 0) -> "NBState":
        """K independent sub-receiver states stacked on a leading axis
        (the vmap axis of the multi-sub-receiver step)."""
        one = cls.create(geo, pol=pol, fir_len=fir_len)
        return jax.tree_util.tree_map(
            lambda x: jnp.repeat(x[None], n_subch, axis=0), one)

    @classmethod
    def from_rx(cls, s: "RxState") -> "NBState":
        return cls(mix1=s.mix1, fft3=s.fft3, mix2=s.mix2, bfo=s.bfo,
                   am=s.am, fm=s.fm, coh=s.coh, agc=s.agc,
                   squelch=s.squelch, pol=s.pol, mix2_fir=s.mix2_fir)


def narrowband_tail(geo: Geometry, p: RxParams, tables: RxTables,
                    nb: NBState, fftx_spec: jax.Array,
                    tune_bin: jax.Array,
                    tune_frac: jax.Array | None = None,
                    tune_slope: jax.Array | None = None):
    """mix1 -> fft3 -> mix2 -> demod -> AGC/expander/squelch for one
    tuned sub-receiver (the reference's narrowband_dsp + mix2 + fft3 +
    detector thread group, SURVEY.md §3.4).

    tune_slope (with per-frame tune_frac): coherent drift tracking —
    the AFC supplies (constant bin, deviation, per-frame slope) via
    AFCTracker.frame_tuning.

    Returns (nb', audio, baseb, agc_gain)."""
    s_mix1, timf3 = mix1_step(geo, tables.mix1, nb.mix1, fftx_spec,
                              tune_bin, tune_frac=tune_frac,
                              tune_slope=tune_slope)
    return narrowband_post_mix1(geo, p, tables, nb, s_mix1, timf3)


def narrowband_post_mix1(geo: Geometry, p: RxParams, tables: RxTables,
                         nb: NBState, s_mix1: Mix1State,
                         timf3: jax.Array):
    """fft3 -> mix2 -> demod -> AGC/expander/squelch on an
    already-downconverted timf3 stream.  Shared between the single-chip
    tail above and the sharded pipeline (parallel/sharded.py), which
    computes mix1 shard-local and gathers timf3 before this replicated
    finale — one implementation of the reference's narrowband thread
    group (wcw.c:1240) for both execution modes.

    Returns (nb', audio, baseb, agc_gain)."""
    fs_bb = geo.baseband_sampling_speed
    with_carrier = p.demod == Demod.COHERENT
    s_fft3, fft3_spec = fft3_step(geo, tables.fft3, nb.fft3, timf3)
    s_fir = nb.mix2_fir
    if p.mixer_mode == 2:
        # time-domain FIR decimator (mix2.c:217-245); the carrier
        # branch still comes from fft3 (mix2.c:246 runs either way)
        s_fir, baseb = mix2_fir_step(geo, tables.mix2.fir, nb.mix2_fir,
                                     timf3)
        s_mix2, carrier = nb.mix2, None
        if with_carrier:
            s_mix2, carrier = mix2_carrier_step(geo, tables.mix2,
                                                nb.mix2, fft3_spec)
    else:
        s_mix2, baseb, carrier = mix2_step(geo, tables.mix2, nb.mix2,
                                           fft3_spec,
                                           with_carrier=with_carrier)
    s_pol = nb.pol
    if p.pol_adapt_enable and geo.channels == 2:
        # adaptive polarization: project the 2-channel baseband onto
        # the dominant coherency eigenvector (pol_graph.c channel
        # combination, applied in the mix2 path)
        s_pol, combined, w = update_polarization(nb.pol, baseb)
        baseb = combined[:, None]
        if carrier is not None:
            carrier = jnp.matmul(carrier, jnp.conj(w),
                                 precision=jax.lax.Precision.HIGHEST
                                 )[:, None]
    s_bfo, s_am, s_fm, s_coh = nb.bfo, nb.am, nb.fm, nb.coh
    if p.demod == Demod.SSB:
        s_bfo, audio = demod_ops.bfo_ssb(nb.bfo, baseb, p.bfo_hz, fs_bb)
    elif p.demod == Demod.AM:
        s_am, audio = demod_ops.am_detect(nb.am, baseb, fs_bb)
    elif p.demod == Demod.FM:
        s_fm, audio = demod_ops.fm_detect(nb.fm, baseb, fs_bb)
        if p.fm_deemphasis_us > 0:
            audio, de_last = demod_ops.fm_deemphasis(
                audio, fs_bb, p.fm_deemphasis_us, s_fm.deemph)
            s_fm = demod_ops.FMState(last=s_fm.last, deemph=de_last)
    elif p.demod == Demod.COHERENT:
        if p.coherent_mode == 1:
            # signal to one ear, amplitude-weighted carrier to the
            # other (bg_coherent==1, mix2.c:1843-1876): the carrier
            # branch is the narrow bg_carrfilter baseband; both ears
            # get the BFO product
            both = jnp.concatenate([baseb, carrier], axis=1)
            s_bfo, audio = demod_ops.bfo_ssb(nb.bfo, both, p.bfo_hz,
                                             fs_bb)
            s_coh = nb.coh
        else:
            s_coh, audio_i, _audio_q = demod_ops.coherent_detect(
                nb.coh, baseb, carrier, fs_bb)
            s_bfo, audio = demod_ops.bfo_ssb(
                nb.bfo, audio_i.astype(jnp.complex64), p.bfo_hz, fs_bb)
    else:  # Demod.NONE — raw complex baseband as "audio" I channel
        audio = jnp.real(baseb)
    if p.agc_enable:
        s_agc, audio, gain = agc_ops.agc(
            nb.agc, audio, fs_bb, p.agc_attack_ms, p.agc_release_ms,
            p.agc_hang_ms)
    else:
        s_agc = nb.agc
        gain = jnp.ones_like(audio)
    if p.expander_exponent > 1.0:
        audio = expander(audio, p.expander_exponent)
    s_squelch = nb.squelch
    if p.squelch_enable:
        s_squelch, audio, _open = squelch_step(
            geo, nb.squelch, fft3_spec, tables.mix2.filt,
            p.squelch_ratio, p.squelch_tc_ms, audio)
    nb_out = NBState(mix1=s_mix1, fft3=s_fft3, mix2=s_mix2, bfo=s_bfo,
                     am=s_am, fm=s_fm, coh=s_coh, agc=s_agc,
                     squelch=s_squelch, pol=s_pol, mix2_fir=s_fir)
    return nb_out, audio, baseb, gain


def _make_wideband_front(geo: Geometry, p: RxParams,
                         blanker_pulsewidth: int):
    """fft1 -> sellim -> back-FFT -> blankers -> fft2 -> spur subtract
    (the shared wideband chain feeding every sub-receiver)."""
    step_seconds = geo.samples_per_step / geo.timf1_sampling_speed

    def front(tables: RxTables, state: RxState, block: jax.Array,
              tune0: jax.Array):
        s_fft1, fft1_spec, step_power = fft1_step(
            geo, tables.fft1, state.fft1, block, p.fft_avg1num)
        s_sellim = state.sellim
        s_timf2 = state.timf2
        s_fft2 = state.fft2
        s_blank = state.blanker
        fft2_power = liminfo_out = n_fit = n_clear = nf_out = None
        if geo.second_fft_enable:
            # protected passband in fft1-bin coordinates
            # (selfreq_liminfo, sellim.c:38-116)
            ratio = geo.fft2_size // geo.fft1_size
            sel_c = tune0 // ratio
            bw_bins = max(
                1, int(0.7 * (p.filter_high_hz - p.filter_low_hz)
                       / geo.fft1_bandwidth)) + 3
            sel_lo = sel_c - bw_bins
            sel_hi = sel_c + bw_bins
            avg_p = jnp.sum(s_fft1.sumsq_avg, axis=-1)
            s_sellim = sellim_ops.update_liminfo(
                geo, state.sellim, avg_p, p.sellim_maxlevel,
                ston=p.sellim_ston, sel_lo=sel_lo, sel_hi=sel_hi)
            wgain, sgain = sellim_ops.liminfo_gains(s_sellim.liminfo)
            s_timf2, weak, strong, wpwr = timf2_step(
                geo, tables.timf2_syn, state.timf2, fft1_spec, wgain,
                sgain)
            nf = state.blanker.noise_floor
            n_fit = jnp.int32(0)
            n_clear = jnp.int32(0)
            # track the floor from the PRE-blank power: the despiked
            # mean already rejects pulses, and tracking post-blank
            # power feeds back (cleared zeros shrink the floor, which
            # clears more — the spiral the reference guards against
            # with its rate>20% floor raise, blank1.c:1573-1586)
            s_blank = blanker_ops.update_noise_floor(
                state.blanker, wpwr, step_seconds)
            if p.blanker_enable:
                weak, wpwr, n_fit = blanker_ops.clever_blanker(
                    weak, wpwr, tables.blanker, nf, p.clever_bln_limit,
                    blanker_pulsewidth, p.max_pulses_per_block,
                    block_size=p.blanker_block_size,
                    rounds=p.blanker_rounds)
                weak, wpwr, n_clear = blanker_ops.stupid_blanker(
                    weak, wpwr, nf, p.stupid_bln_limit,
                    blanker_pulsewidth)
            from ..ops.fft2 import fft2_power_update, fft2_transform
            t2_tail, fftx_spec = fft2_transform(
                geo, tables.fft2, state.fft2.tail, weak, strong)
            s_spur = state.spur
            if p.spur_enable:
                # subtract BEFORE the power spectrum, as the reference
                # runs eliminate_spurs ahead of its power block
                # (fft2.c:648-670) — cancelled spurs vanish from the
                # waterfall and the auto-search never re-adds them
                s_spur, fftx_spec = spur_subtract_step(
                    geo, tables.spur_template, state.spur, fftx_spec)
            s_fft2, fft2_power = fft2_power_update(
                geo, state.fft2, t2_tail, fftx_spec, p.fft_avg1num)
            liminfo_out = s_sellim.liminfo
            nf_out = s_blank.noise_floor
        else:
            fftx_spec = fft1_spec
            s_spur = state.spur
            if p.spur_enable:
                s_spur, fftx_spec = spur_subtract_step(
                    geo, tables.spur_template, state.spur, fftx_spec)
        wide = dict(fft1=s_fft1, sellim=s_sellim, timf2=s_timf2,
                    fft2=s_fft2, blanker=s_blank, spur=s_spur)
        aux = dict(step_power=step_power, fft2_power=fft2_power,
                   liminfo=liminfo_out, blanker_fitted=n_fit,
                   blanker_cleared=n_clear, noise_floor=nf_out)
        return wide, fftx_spec, aux

    return front


def make_rx_step(geo: Geometry, p: RxParams, blanker_pulsewidth: int = 2,
                 fractional_tune: bool = False):
    """Build the pure step function for this configuration.

    Returns ``step(tables, state, block, tune_bin) -> (state, outputs)``
    with block (samples_per_step, C) complex64 and tune_bin a traced
    int32 fftx bin index (retuning does not recompile).

    With ``fractional_tune`` the step takes a fifth traced argument
    ``tune_frac`` (float32 bin fraction, set_mix1_phases mix1.c:781) so
    ANY dial frequency lands exactly at DC, and an optional sixth
    ``tune_slope`` (per-frame drift in bins/hop — the do_mix1_afc
    intra-transform chirp capability, mix1.c:648/103-106) for coherent
    drift tracking while the AFC is locked."""
    front = _make_wideband_front(geo, p, blanker_pulsewidth)

    def step(tables: RxTables, state: RxState, block: jax.Array,
             tune_bin: jax.Array,
             tune_frac: jax.Array | None = None,
             tune_slope: jax.Array | None = None
             ) -> tuple[RxState, RxOutputs]:
        # tune_bin may be scalar (fixed tuning) or (n_fftx,) per-frame
        # (the AFC path, do_mix1_afc mix1.c:648)
        if not fractional_tune:
            tune_frac = None
            tune_slope = None
        tune0 = jnp.reshape(tune_bin, (-1,))[0]
        wide, fftx_spec, aux = front(tables, state, block, tune0)
        nb, audio, baseb, gain = narrowband_tail(
            geo, p, tables, NBState.from_rx(state), fftx_spec, tune_bin,
            tune_frac=tune_frac, tune_slope=tune_slope)
        new_state = RxState(fft1=wide["fft1"], mix1=nb.mix1,
                            fft3=nb.fft3, mix2=nb.mix2, bfo=nb.bfo,
                            am=nb.am, fm=nb.fm, coh=nb.coh, agc=nb.agc,
                            sellim=wide["sellim"], timf2=wide["timf2"],
                            fft2=wide["fft2"], blanker=wide["blanker"],
                            spur=wide["spur"], squelch=nb.squelch,
                            pol=nb.pol, mix2_fir=nb.mix2_fir)
        outputs = RxOutputs(audio=audio, baseb=baseb,
                            fft1_power=aux["step_power"],
                            fft1_avg_power=wide["fft1"].sumsq_avg,
                            agc_gain=gain, fft2_power=aux["fft2_power"],
                            liminfo=aux["liminfo"],
                            blanker_fitted=aux["blanker_fitted"],
                            blanker_cleared=aux["blanker_cleared"],
                            noise_floor=aux["noise_floor"])
        return new_state, outputs

    return step


def make_multi_rx_step(geo: Geometry, p: RxParams,
                       blanker_pulsewidth: int = 2):
    """Multi-sub-receiver step: ONE wideband front end feeding K
    independently tuned narrowband sub-receivers.

    The reference reserves MIX1_NO_OF_CHANNELS=24 mix1 channel slots
    (globdef.h:315) and fans narrowband "userx" consumers out over the
    network (NET_RX_STRUCT.userx_no/userx_freq globdef.h:1282-1294);
    here the sub-receivers are a vmapped batch axis over the narrowband
    tail — the batched form: the tail's small FFTs and filters batch
    into single fat kernels across sub-channels.

    Returns ``step(tables, state, nbs, block, tune_bins) ->
    ((state, nbs), outputs)`` where nbs is an NBState with leading axis
    K (NBState.create_stacked) and tune_bins is int32 (K,) — or (K, n)
    for per-frame AFC tuning per sub-receiver.  outputs.audio/baseb/
    agc_gain carry the K axis in front.
    """
    front = _make_wideband_front(geo, p, blanker_pulsewidth)
    tail = jax.vmap(
        lambda nb, tune, tables, fftx: narrowband_tail(
            geo, p, tables, nb, fftx, tune),
        in_axes=(0, 0, None, None))

    def step(tables: RxTables, state: RxState, nbs: NBState,
             block: jax.Array, tune_bins: jax.Array):
        tune0 = jnp.reshape(tune_bins, (-1,))[0]
        wide, fftx_spec, aux = front(tables, state, block, tune0)
        nbs_out, audio, baseb, gain = tail(nbs, tune_bins, tables,
                                           fftx_spec)
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
                            fft1_avg_power=wide["fft1"].sumsq_avg,
                            agc_gain=gain, fft2_power=aux["fft2_power"],
                            liminfo=aux["liminfo"],
                            blanker_fitted=aux["blanker_fitted"],
                            blanker_cleared=aux["blanker_cleared"],
                            noise_floor=aux["noise_floor"])
        return (new_state, nbs_out), outputs

    return step
