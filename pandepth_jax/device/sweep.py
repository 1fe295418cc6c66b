"""Position-sorted event sweep: depth reconstruction + region statistics.

Depth as a function of genome position is piecewise constant with
breakpoints exactly at the coverage events, so instead of materializing
a per-base array (the reference's SiteInfo arrays / window buffers,
src/PanDepth.cpp:4129-4145, :715-723) we:

1. sort events by position (one ``lax.sort`` — O(E log E), vectorized),
2. running-sum the deltas -> depth of every inter-event piece,
3. prefix-sum each piece's contribution to CoveredSite and TotalDepth
   (a site counts iff ``depth >= minDep``, src/PanDepth.cpp:319-324),
4. evaluate those prefix integrals at arbitrary region boundaries with
   a batched binary search.

Every target segment's stats are then two gathers, and stats are
*additive across disjoint position ranges*, which is what makes genome
range-sharding across chips a plain ``psum`` (see sharding/).

``wrap18`` replicates the reference's 18-bit SiteInfo depth cells
(include/DataClass.h:84-87, quirk Q1) for the code paths that use them.
"""

from __future__ import annotations

import functools

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp


WRAP18_MASK = 0x3FFFF


@functools.partial(jax.jit, static_argnames=("min_dep", "wrap18"))
def sort_events(ev_pos, ev_delta, min_dep: int = 1, wrap18: bool = False):
    """Sort events and precompute the sweep state.

    Returns (pos_sorted, depth, c_cov, c_sum, delta_sorted):
      pos_sorted:   (E,) int64 ascending (sentinels last)
      depth:        (E,) int32 depth on piece [pos[i], pos[i+1])
      c_cov:        (E,) int64 inclusive prefix of covered-length per piece
      c_sum:        (E,) int64 inclusive prefix of depth-sum per piece
      delta_sorted: (E,) int32 (kept so more events can be merged later)
    """
    pos_s, delta_s = jax.lax.sort_key_val(ev_pos, ev_delta)
    depth = jnp.cumsum(delta_s, dtype=jnp.int32)
    if wrap18:
        depth = depth & WRAP18_MASK
    covered = depth >= min_dep
    # positions may be int32 (genomes < 2^31) or int64; the piece ending
    # at the dtype-max sentinel can wrap, but its depth is always 0
    # (deltas balance), so the wrapped length is discarded by `covered`
    pmax = jnp.iinfo(pos_s.dtype).max
    nxt = jnp.concatenate([pos_s[1:],
                           jnp.full((1,), pmax, pos_s.dtype)])
    plen = jnp.where(covered, nxt - pos_s, 0).astype(jnp.int64)
    c_cov = jnp.cumsum(plen)
    c_sum = jnp.cumsum(plen * depth.astype(jnp.int64))
    return pos_s, depth, c_cov, c_sum, delta_s


# The ``jnp.searchsorted`` method that ranks boundaries against the
# sorted events: a batched binary search at every batch size, because
# ``"sort"`` re-sorts every event with the queries. Over 15.2M events
# on an H100 (NVIDIA H100 80GB HBM3, 400 W and 700 W; chip_smoke.py
# phase 2) the binary search took 0.15-0.63 ms against 1.24-1.54 ms
# for ``"sort"`` at 256 to 1M queries; on the CPU backend ``"sort"``
# cost a 16M-event run 1.5x its wall.
SEARCH_METHOD = "scan_unrolled"


def _q_eval(pos_s, depth, c_cov, c_sum, min_dep, x, method):
    """Q_cov(x), Q_sum(x): integrals of the covered indicator and of
    covered depth over [0, x) for a batch of boundaries ``x``.

    Piece i spans [pos_s[i], pos_s[i+1]); a query splits piece r-1
    (r = first event index with position >= x) into a fully counted
    prefix (c_* up to piece r-2) plus a partial remainder."""
    r = jnp.searchsorted(pos_s, x, side="left",
                         method=method).astype(jnp.int32)
    e = pos_s.shape[0]
    i_full = jnp.clip(r - 2, 0, e - 1)
    i_part = jnp.clip(r - 1, 0, e - 1)
    full_cov = jnp.where(r >= 2, c_cov[i_full], 0)
    full_sum = jnp.where(r >= 2, c_sum[i_full], 0)
    ind = (depth[i_part] >= min_dep).astype(jnp.int64)
    diff = (x - pos_s[i_part]).astype(jnp.int64)
    part_len = jnp.where(r >= 1, diff * ind, 0)
    q_cov = full_cov + part_len
    q_sum = full_sum + part_len * depth[i_part].astype(jnp.int64)
    return q_cov, q_sum


@functools.partial(jax.jit, static_argnames=("method",))
def eval_pair(pos_s, depth, c_cov, c_sum, min_dep, lo, hi,
              method=SEARCH_METHOD):
    """Fused (Q(hi) - Q(lo)) for segment batches: one searchsorted over
    the concatenated boundaries, one dispatch. ``method`` is only
    overridden to compare the searchsorted methods."""
    b = lo.shape[0]
    q_cov, q_sum = _q_eval(pos_s, depth, c_cov, c_sum, min_dep,
                           jnp.concatenate([lo, hi]), method)
    return q_cov[b:] - q_cov[:b], q_sum[b:] - q_sum[:b]


@jax.jit
def eval_boundaries(pos_s, depth, c_cov, c_sum, min_dep, x):
    """Q_cov(x), Q_sum(x) for a batch of int64 boundaries ``x``
    (see :func:`_q_eval`). ``min_dep`` is a traced int32 scalar (same
    value the prefixes were built with)."""
    return _q_eval(pos_s, depth, c_cov, c_sum, min_dep, x, SEARCH_METHOD)


@functools.partial(jax.jit, static_argnames=("min_dep", "wrap18",
                                             "want_state"))
def finalize_chunked(chunks_pos, chunks_delta, seg_lo, seg_hi,
                     min_dep: int = 1, wrap18: bool = False,
                     want_state: bool = True):
    """finalize_segments over a TUPLE of event chunks: the concat, the
    sort, the scans and the boundary eval fuse into ONE dispatch (the
    streaming feed leaves one device array per staged flush)."""
    pos = jnp.concatenate(list(chunks_pos))
    delta = jnp.concatenate(list(chunks_delta))
    return finalize_segments(pos, delta, seg_lo, seg_hi,
                             min_dep=min_dep, wrap18=wrap18,
                             want_state=want_state)


def _decode_enc_group(codes, excs, slots, bases):
    """Decode one group of NB same-shape (B, 2, CAP) code blocks
    (``[:, 0]`` = zigzag start deltas, ``[:, 1]`` = lengths) — windows
    arrive pre-stacked in blocks so each host->device transfer carries
    B windows, and deltas+lengths share it — into
    flat (start, end) vectors. The escape value is the code dtype's
    max (255 for uint8, 65535 for uint16); the (B, 2, CE) int64 side
    lists carry the true values and the (B, 2, CE) int32 ``slots``
    carry each escape's position in its row (computed host-side at
    block-stack time; unused entries point at CAP). Escapes are
    applied as a CE-sized scatter-add of corrections, so only the
    rare escapes are touched instead of a per-element gather over
    every code. Zero-filled
    tail slots/rows decode to zero-length events at the previous
    position — depth-neutral by construction."""
    cc = jnp.concatenate(list(codes), axis=0)    # (NB*B, 2, CAP)
    ee = jnp.concatenate(list(excs), axis=0)     # int64 side lists
    ss = jnp.concatenate(list(slots), axis=0)    # int32 slot indices
    dd, ll = cc[:, 0], cc[:, 1]
    excd, excl = ee[:, 0], ee[:, 1]              # (rare escapes)
    sd, sl = ss[:, 0], ss[:, 1]
    cap = dd.shape[1]
    esc = int(jnp.iinfo(dd.dtype).max)
    zig_esc = (esc >> 1) ^ -(esc & 1)
    pdt = bases.dtype               # int32 when the genome fits, else
    zz = dd.astype(pdt)             # int64 (3 Gb+ layouts)
    delta = (zz >> 1) ^ -(zz & 1)   # escape slots decode to zig_esc
    rows = jnp.arange(dd.shape[0], dtype=jnp.int32)[:, None]
    # correction at each escape slot: true value minus what the plain
    # zigzag already contributed; padded entries land in column CAP
    # and are sliced off
    corr_d = jnp.zeros((dd.shape[0], cap + 1), pdt).at[
        rows, sd].add((excd - zig_esc).astype(pdt))
    starts = bases[:, None] + jnp.cumsum(delta + corr_d[:, :cap],
                                         axis=1, dtype=pdt)
    lv = ll.astype(pdt)             # escape slots hold esc
    corr_l = jnp.zeros((dd.shape[0], cap + 1), pdt).at[
        rows, sl].add((excl - esc).astype(pdt))
    lens = lv + corr_l[:, :cap]
    return starts.ravel(), (starts + lens).ravel()


def _decode_const_group(codes, excs, slots, bases, lens, ns):
    """Decode one group of NB same-shape (B, CAP) CONST-LENGTH code
    blocks: a window whose event lengths are all identical (the
    dominant real profile — fixed-read-length data with whole-read M
    segments) ships only its zigzag start-delta plane plus one scalar
    length per window, HALVING the wire bytes of the mixed format
    (_decode_enc_group). ``lens`` carries each window's event length,
    ``ns`` its live pair count (tail slots decode to zero-length
    events — the mixed format got that from its zero length codes;
    here the mask supplies it)."""
    cc = jnp.concatenate(list(codes), axis=0)    # (NB*B, CAP)
    ee = jnp.concatenate(list(excs), axis=0)     # int64 delta escapes
    ss = jnp.concatenate(list(slots), axis=0)    # int32 slot indices
    cap = cc.shape[1]
    esc = int(jnp.iinfo(cc.dtype).max)
    zig_esc = (esc >> 1) ^ -(esc & 1)
    pdt = bases.dtype
    zz = cc.astype(pdt)
    delta = (zz >> 1) ^ -(zz & 1)
    rows = jnp.arange(cc.shape[0], dtype=jnp.int32)[:, None]
    corr_d = jnp.zeros((cc.shape[0], cap + 1), pdt).at[
        rows, ss].add((ee - zig_esc).astype(pdt))
    starts = bases[:, None] + jnp.cumsum(delta + corr_d[:, :cap],
                                         axis=1, dtype=pdt)
    live = jnp.arange(cap, dtype=jnp.int32)[None, :] < ns[:, None]
    lens_full = jnp.where(live, lens[:, None].astype(pdt),
                          jnp.zeros((), pdt))
    return starts.ravel(), (starts + lens_full).ravel()


@functools.partial(jax.jit, static_argnames=("min_dep", "wrap18",
                                             "want_state"))
def finalize_encoded(g8, g16, gc8, gc16, raw_pos, raw_delta,
                     seg_lo, seg_hi,
                     min_dep: int = 1, wrap18: bool = False,
                     want_state: bool = True):
    """Decode compact event windows + finalize in ONE dispatch.

    The native loader ships ~2 B/event instead of 8 B of raw
    positions (uint8 codes, deep-coverage profile) or ~4 B/event
    (uint16 codes,
    sparse runs whose start gaps overflow 8-bit zigzag) — and HALF
    that again for const-length windows (``gc8``/``gc16``: uniform
    event length, the fixed-read-length profile; see
    _decode_const_group). ``g8``/``g16`` are (codes, excs, bases)
    stacked window-block groups — see _decode_enc_group for the wire
    format. ``raw_pos``/``raw_delta`` are extra pre-built event chunks
    (other feeds) merged into the same sort.
    """
    s8, e8 = _decode_enc_group(*g8)
    s16, e16 = _decode_enc_group(*g16)
    sc8, ec8 = _decode_const_group(*gc8)
    sc16, ec16 = _decode_const_group(*gc16)
    ones8 = jnp.ones(s8.shape[0], jnp.int32)
    ones16 = jnp.ones(s16.shape[0], jnp.int32)
    onesc8 = jnp.ones(sc8.shape[0], jnp.int32)
    onesc16 = jnp.ones(sc16.shape[0], jnp.int32)
    pos = jnp.concatenate([s8, e8, s16, e16, sc8, ec8, sc16, ec16,
                           *raw_pos])
    dlt = jnp.concatenate([ones8, -ones8, ones16, -ones16,
                           onesc8, -onesc8, onesc16, -onesc16,
                           *raw_delta])
    return finalize_segments(pos, dlt, seg_lo, seg_hi,
                             min_dep=min_dep, wrap18=wrap18,
                             want_state=want_state)


@functools.partial(jax.jit, static_argnames=("min_dep", "wrap18",
                                             "want_state"))
def finalize_segments(ev_pos, ev_delta, seg_lo, seg_hi,
                      min_dep: int = 1, wrap18: bool = False,
                      want_state: bool = True):
    """Sort + scan + boundary eval in ONE dispatch. Returns (cover,
    dsum, pos_s, depth, c_cov, c_sum, delta_s) so the caller can cache
    the sweep state for further queries — or just (cover, dsum) when
    ``want_state`` is False: single-query runs (no -a, no later stats
    pass) need not keep ~28 B/event of sweep state alive on the
    device."""
    pos_s, depth, c_cov, c_sum, delta_s = sort_events(
        ev_pos, ev_delta, min_dep=min_dep, wrap18=wrap18)
    md = jnp.int32(min_dep)
    cover, dsum = eval_pair(pos_s, depth, c_cov, c_sum, md, seg_lo,
                            seg_hi)
    if not want_state:
        return cover, dsum
    return cover, dsum, pos_s, depth, c_cov, c_sum, delta_s
