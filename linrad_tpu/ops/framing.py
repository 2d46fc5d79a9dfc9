"""Overlap framing and overlap-add — the JAX replacement for Linrad's
circular-buffer discipline.

Linrad streams samples through power-of-two circular buffers with one
creator / one consumer pointer per buffer (reference z_BUFFERS.txt:1-50,
timf1 fill lsetad.c:1074-1090).  Here the same dataflow is expressed as
static-shape batch framing: each jitted pipeline step consumes a fixed
block of samples plus a carried tail (the "history" the circular buffer
provided), produces a fixed batch of overlapped frames, and carries the
new tail forward in the pipeline state.  All shapes are static; the only
state is the tail arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


from .cplx import cgather  # complex-safe gather (see ops/cplx.py)


def frame_stream(tail: jax.Array, block: jax.Array, frame_size: int,
                 hop: int) -> tuple[jax.Array, jax.Array]:
    """Split ``concat(tail, block)`` into overlapped frames.

    tail:  (frame_size - hop, ...) carried samples from the previous step
    block: (S, ...) new samples with S % hop == 0

    Returns (frames, new_tail) with frames shape (S//hop, frame_size, ...)
    and new_tail the last (frame_size - hop) samples for the next step.
    Frame b covers absolute samples [b*hop, b*hop + frame_size) of the
    concatenated stream — the analog of Linrad's interleaved fft1 input
    blocks (buf.c:303-327).
    """
    overlap = frame_size - hop
    assert tail.shape[0] == overlap, (tail.shape, overlap)
    s = block.shape[0]
    assert s % hop == 0, (s, hop)
    n = s // hop
    buf = jnp.concatenate([tail, block], axis=0)
    if frame_size % hop == 0:
        # gather-free framing: when the hop divides the frame (every
        # sin^N geometry: 50%/75% overlap), frame b is the
        # concatenation of hop-sized chunks b..b+k-1, so the whole
        # batch is k static slices stacked — no gather at all.
        k = frame_size // hop
        chunks = buf.reshape((n + k - 1, hop) + buf.shape[1:])
        # NB lax.slice + expand_dims, not chunks[j:j+n, None]: jnp's
        # mixed basic indexing with None lowers to a (complex) gather
        frames = jnp.concatenate(
            [jnp.expand_dims(jax.lax.slice_in_dim(chunks, j, j + n), 1)
             for j in range(k)], axis=1)
        frames = frames.reshape((n, frame_size) + buf.shape[1:])
    else:
        idx = (jnp.arange(n)[:, None] * hop
               + jnp.arange(frame_size)[None, :])
        frames = cgather(buf, idx)
    new_tail = buf[s:]
    return frames, new_tail


def make_tail(frame_size: int, hop: int, trailing_shape=(),
              dtype=jnp.complex64) -> jax.Array:
    """Zero-initialised carry tail for :func:`frame_stream`."""
    shape = (frame_size - hop,) + tuple(trailing_shape)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        from .cplx import czeros
        return czeros(shape, dtype)
    return jnp.zeros(shape, dtype)


def overlap_add(frames: jax.Array, hop: int, carry: jax.Array
                ) -> tuple[jax.Array, jax.Array]:
    """Overlap-add a batch of frames at the given hop.

    frames: (n, frame_size, ...); carry: (frame_size - hop, ...) partial
    sums carried from the previous step.

    Returns (out, new_carry): out has shape (n*hop, ...) — the completed
    samples — and new_carry holds the trailing partial sums.  This is the
    vectorised form of Linrad's in-place circular-buffer accumulation in
    ``fft1back_fp_finish`` (reference timf2.c:970-1160) and the mix1
    overlap-add (mix1.c:141-280): instead of scattering into a ring, each
    frame is split into ``k`` hop-sized chunks and the chunks are summed
    with static shifts — pure slicing, no scatter, so XLA fuses it.
    """
    n, size = frames.shape[0], frames.shape[1]
    overlap = size - hop
    assert carry.shape[0] == overlap
    k = -(-size // hop)  # chunks per frame
    pad = k * hop - size
    if pad:
        pad_widths = [(0, 0)] * frames.ndim
        pad_widths[1] = (0, pad)
        frames = jnp.pad(frames, pad_widths)
    trailing = frames.shape[2:]
    chunks = frames.reshape((n, k, hop) + trailing)
    # accumulate: output block m (0..n+k-2) = sum_j chunks[m-j, j]
    total = jnp.zeros((n + k - 1, hop) + trailing, frames.dtype)
    for j in range(k):
        total = total.at[j: j + n].add(chunks[:, j])
    flat = total.reshape((-1,) + trailing)  # ((n+k-1)*hop, ...)
    flat = flat.at[:overlap].add(carry)
    out = flat[: n * hop]
    new_carry = flat[n * hop: n * hop + overlap]
    return out, new_carry
