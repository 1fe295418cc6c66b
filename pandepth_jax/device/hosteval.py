"""Host-side (pure numpy) twins of the device event-sweep pipeline.

IMPORTS NO JAX — this module is the compute core of the host-finalize
engine (device/host_engine.py), which answers a run on a machine
without an accelerator and serves as the parity reference for the
device engines. The device engine (device/engine.py) delegates its own
host-eval paths here so the two engines share one implementation.

Semantics are the device sweep's exactly (device/sweep.py): depth is
piecewise constant between position-sorted events; CoveredSite /
TotalDepth integrate pieces with ``depth >= min_dep`` (reference
src/PanDepth.cpp:319-324); ``Q(x)`` integrates over ``[0, x)`` and a
segment is ``Q(hi) - Q(lo)``; ``wrap18`` masks the running depth to 18
bits (DataClass.h:84-87, quirk Q1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

# bit i set <=> CIGAR op i consumes reference (M D N = X); device
# twin: device/events.py (which re-exports these for device users)
REF_CONSUME_MASK = 0b110001101
# bit i set <=> CIGAR op i adds depth (M = X)
DEPTH_MASK = 0b110000001

SENTINEL = 1 << 62
WRAP18_MASK = 0x3FFFF


def pad_pow2(n: int, floor: int = 1024) -> int:
    """Round up to a power of two (bounded jit-cache growth)."""
    p = floor
    while p < n:
        p <<= 1
    return p


def pos_dtype_for(total: int):
    """Position dtype for a padded-genome span of ``total``.

    int32 under 2 Gb; uint32 up to 4 Gb (covers the reference's own
    3 Gb benchmark genome, reference/README.md:128, at half the int64
    sort width and transfer bytes); int64 beyond that."""
    if total < (1 << 31) - 2:
        return np.int32
    if total < (1 << 32) - 2:
        return np.uint32
    return np.int64


def wants_encoded_windows() -> bool:
    """Feed format of the single-device engine: compact ~2 B/event code
    windows (:func:`decode_enc_host` is their twin) only with
    ``PANDEPTH_ENC=1``, else raw 32/64-bit positions. On an H100
    (8M-read 3 Gb fixture, cold chr and gene runs,
    ``chip_smoke.py --feed-timing``) raw positions tied the code
    windows without their finalize warm-up and finished about 1 s
    before the code windows with it, and raw needs no warm-up. On the
    CPU backend the code windows' block padding dominates the
    finalize sort."""
    return os.environ.get("PANDEPTH_ENC") == "1"


@dataclasses.dataclass
class SegmentStats:
    cover: np.ndarray      # int64 per segment
    depth_sum: np.ndarray  # int64 per segment


def host_extract_events(batch, offsets: np.ndarray, limits: np.ndarray,
                        flags_mask: int, min_mapq: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of device/events.extract_events: (starts, ends)
    int64 global clamped M/=/X segments of kept reads."""
    tid, pos = batch.tid, batch.pos
    keep = (batch.flag & flags_mask) == 0
    keep &= tid >= 0
    if min_mapq >= 1:
        keep &= batch.mapq >= min_mapq

    opc, opl, opr = batch.op_code, batch.op_len, batch.op_read
    m = opc.shape[0]
    if m == 0:
        z = np.zeros(0, np.int64)
        return z, z
    consumes = (REF_CONSUME_MASK >> opc) & 1
    clen = (opl * consumes).astype(np.int64)
    excl = np.cumsum(clen) - clen
    # rebase the running ref-consumed length at each read's first op
    new = np.empty(m, bool)
    new[0] = True
    new[1:] = opr[1:] != opr[:-1]
    group = np.cumsum(new) - 1
    off = excl - excl[new][group]

    tid_safe = np.maximum(tid, 0)
    floor = offsets[tid_safe]
    base = floor + pos.astype(np.int64)
    limit = limits[tid_safe]

    start = base[opr] + off
    end = start + opl
    np.clip(start, floor[opr], limit[opr], out=start)
    np.clip(end, floor[opr], limit[opr], out=end)
    live = (((DEPTH_MASK >> opc) & 1) == 1) & keep[opr] & (end > start)
    return start[live], end[live]


def decode_enc_host(d8: np.ndarray, l8: np.ndarray, excd: np.ndarray,
                    excl: np.ndarray, base: int,
                    n: Optional[int] = None):
    """Numpy twin of the device decode in sweep.finalize_encoded
    (spill path + differential tests). Works for both code widths
    (uint8 / uint16): the escape value is the dtype max."""
    if n is None:
        n = d8.shape[0]
    esc = int(np.iinfo(d8.dtype).max)
    zz = d8[:n].astype(np.int64)
    is_d = zz == esc
    delta = (zz >> 1) ^ -(zz & 1)
    delta[is_d] = excd[: int(is_d.sum())]
    starts = base + np.cumsum(delta, dtype=np.int64)
    lens = l8[:n].astype(np.int64)
    is_l = lens == esc
    lens[is_l] = excl[: int(is_l.sum())]
    return starts, starts + lens


def dense_from_state(pos_np: np.ndarray, depth_np: np.ndarray,
                     lo: int, hi: int) -> np.ndarray:
    """Per-base depth over global [lo, hi) from sorted breakpoints.

    Depth is piecewise constant between sorted events, so the dense
    array is a run-length expansion (np.repeat) — O(range), not a
    per-base binary search."""
    if hi <= lo:
        return np.zeros(0, np.int32)
    a = int(np.searchsorted(pos_np, lo, side="right"))
    b = int(np.searchsorted(pos_np, hi, side="left"))
    # runs: [lo, p_a), [p_a, p_{a+1}), ..., [p_{b-1}, hi)
    bounds = np.empty(b - a + 2, np.int64)
    bounds[0] = lo
    bounds[1:-1] = pos_np[a:b]
    bounds[-1] = hi
    vals = np.empty(b - a + 1, np.int32)
    vals[0] = depth_np[a - 1] if a > 0 else 0
    vals[1:] = depth_np[a:b]
    return np.repeat(vals, np.diff(bounds)).astype(np.int32,
                                                   copy=False)


def derive_integrals(pos_s: np.ndarray, depth: np.ndarray,
                     min_dep: int):
    """(pos_s, depth, c_cov, c_sum) sweep tuple from sorted
    breakpoints (inclusive prefix integrals per piece)."""
    if pos_s.shape[0] == 0:  # no events (e.g. every read filtered)
        z = np.zeros(0, np.int64)
        return pos_s, depth, z, z
    covered = depth >= min_dep
    nxt = np.empty_like(pos_s)
    nxt[:-1] = pos_s[1:]
    nxt[-1] = np.iinfo(np.int64).max
    plen = np.where(covered, nxt - pos_s, 0)
    c_cov = np.cumsum(plen)
    c_sum = np.cumsum(plen * depth.astype(np.int64))
    return pos_s, depth, c_cov, c_sum


def host_q_eval(sweep, min_dep: int, x: np.ndarray, r: np.ndarray):
    """Q_cov(x), Q_sum(x) given each query's event rank r[j] =
    #{events < x[j]} (numpy twin of sweep.eval_boundaries)."""
    pos_s, depth, c_cov, c_sum = sweep
    e = pos_s.shape[0]
    if e == 0:  # no events at all (e.g. every read filtered): the
        # device twin's clamped gathers return 0 here implicitly
        z = np.zeros(x.shape[0], np.int64)
        return z, z
    i_full = np.clip(r - 2, 0, e - 1)
    i_part = np.clip(r - 1, 0, e - 1)
    full_cov = np.where(r >= 2, c_cov[i_full], 0)
    full_sum = np.where(r >= 2, c_sum[i_full], 0)
    ind = (depth[i_part] >= min_dep).astype(np.int64)
    diff = x - pos_s[i_part]
    part_len = np.where(r >= 1, diff * ind, 0)
    return (full_cov + part_len,
            full_sum + part_len * depth[i_part].astype(np.int64))


def clamp_segments(layout, seg_tid: np.ndarray, seg_start: np.ndarray,
                   seg_end: np.ndarray):
    """1-based inclusive [seg_start, seg_end] -> clamped global
    half-open [lo, hi) int64 boundaries (the engines' shared
    prologue; a BED region overhanging a contig reads the same slack
    cells the reference's arrays expose)."""
    lo = layout.offsets[seg_tid] + np.maximum(
        np.asarray(seg_start, np.int64) - 1, 0)
    hi = layout.offsets[seg_tid] + np.asarray(seg_end, np.int64)
    lo = np.minimum(lo, layout.limits[seg_tid])
    hi = np.minimum(hi, layout.limits[seg_tid])
    hi = np.maximum(hi, lo)
    return lo, hi


def eval_sorted_host(layout, min_dep: int, sweep, seg_tid: np.ndarray,
                     seg_start: np.ndarray, seg_end: np.ndarray
                     ) -> Optional[SegmentStats]:
    """Segment stats for a batch whose GLOBAL boundaries arrive sorted
    non-decreasing (returns None otherwise — the caller falls back to
    the generic eval) (mode-6 window tilings: tid-major, start-minor —
    src/PanDepth.cpp:4313-4317 always emits them so).

    Ranking B sorted queries against E sorted events is one
    searchsorted(queries, events) + bincount-cumsum — O(E log B + B),
    no per-query binary search."""
    lo, hi = clamp_segments(layout, seg_tid, seg_start, seg_end)
    if np.any(np.diff(lo) < 0) or np.any(np.diff(hi) < 0):
        return None  # rank_sorted requires sorted queries
    pos_s = sweep[0]

    def rank_sorted(x: np.ndarray) -> np.ndarray:
        # r[j] = #{events < x[j]} for sorted x: each event lands at
        # its first strictly-greater query index; prefix-count
        j0 = np.searchsorted(x, pos_s, side="right")
        return np.cumsum(np.bincount(j0, minlength=x.shape[0] + 1)
                         )[: x.shape[0]].astype(np.int64)

    qc_lo, qs_lo = host_q_eval(sweep, min_dep, lo, rank_sorted(lo))
    qc_hi, qs_hi = host_q_eval(sweep, min_dep, hi, rank_sorted(hi))
    return SegmentStats(cover=qc_hi - qc_lo, depth_sum=qs_hi - qs_lo)


def window_grid_host(layout, min_dep: int, sweep,
                     seg_tid: np.ndarray, seg_start: np.ndarray,
                     seg_end: np.ndarray, win: int
                     ) -> Optional[SegmentStats]:
    """Window stats for a regular tiling, or None when the batch isn't
    one (caller falls back to the generic eval).

    The tiling (small_window_tiling) is an arithmetic grid per contig —
    window j of contig t spans global [off_t + j*win, off_t + (j+1)*win)
    with only the LAST window clipped — so instead of evaluating 2
    boundaries per window (30 M random gathers at ``-w 100`` on a 3 Gb
    genome; this host's large-gather latency is erratic under
    khugepaged), each covered depth PIECE scatters its overlap into the
    grid: bincount point-adds for the edge windows, a diff-array +
    cumsum for the full interior windows — O(E) scatter + O(W)
    sequential cumsum, nothing random-access.

    Weights ride float64 bincounts: every addend is bounded by
    win * 2^18 < 2^26 and running sums stay far below 2^53, so the
    integer results are exact. (The piece->contig assignment relies on
    min_dep >= 1 — covered pieces then lie inside read intervals,
    which never span contigs — and the engines clamp min_dep >= 1.)"""
    lay = layout
    w = int(win)
    counts = np.bincount(seg_tid, minlength=lay.n_targets)
    # the regular tiling is fully determined by (contig length, win):
    # ceil((L-1)/win) windows, last end = min(K*win, L)
    exp_counts = np.where(lay.lengths > 1,
                          -(-(lay.lengths - 1) // w), 0)
    used = counts > 0
    if not np.array_equal(counts[used], exp_counts[used]):
        return None
    if seg_start.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return SegmentStats(cover=z, depth_sum=z)
    woff = np.zeros(lay.n_targets + 1, np.int64)
    np.cumsum(counts, out=woff[1:])
    # cheap structural spot-checks (full interior follows from the
    # count + grid construction)
    first = woff[:-1][used]
    last = woff[1:][used] - 1
    if not (np.all(seg_start[first] == 1)
            and np.all(seg_end[last] ==
                       np.minimum(counts[used] * w,
                                  lay.lengths[used]))
            and np.all(seg_end[first] ==
                       np.minimum(w, lay.lengths[used]))):
        return None

    W = int(seg_start.shape[0])
    pos_s, depth = sweep[0], sweep[1]
    if pos_s.shape[0] == 0:  # no events: every window is zero
        z = np.zeros(W, np.int64)
        return SegmentStats(cover=z, depth_sum=z)
    if int(used.sum()) == 1:
        # single-contig call (the mode-6 streaming writer evaluates
        # per contig): slice the sorted breakpoints to this contig's
        # grid range so each call is O(E_contig + W_contig) instead of
        # re-scanning every breakpoint of the genome (12x the work at
        # -w 100 on 12 contigs — measured 8.7 s -> ~0.9 s total).
        # Sound because covered pieces lie inside read intervals,
        # which are clamped per contig: a covered piece overlapping
        # [off_t, grid_end) always has its start inside it.
        t_only = int(np.nonzero(used)[0][0])
        g0_ = int(lay.offsets[t_only])
        ge_ = g0_ + int(counts[t_only]) * w
        i0 = int(np.searchsorted(pos_s, g0_, side="left"))
        i1 = int(np.searchsorted(pos_s, ge_, side="left"))
        pos_v = pos_s[i0:i1]
        depth_v = depth[i0:i1]
        nxt = np.empty_like(pos_v)
        if pos_v.shape[0]:
            nxt[:-1] = pos_s[i0 + 1:i1]
            nxt[-1] = pos_s[i1] if i1 < pos_s.shape[0] \
                else np.iinfo(np.int64).max
    else:
        pos_v, depth_v = pos_s, depth
        nxt = np.empty_like(pos_s)
        nxt[:-1] = pos_s[1:]
        nxt[-1] = np.iinfo(np.int64).max
    covered = depth_v >= min_dep
    sel = covered & (nxt > pos_v)
    a = pos_v[sel]
    b = nxt[sel]
    d = depth_v[sel].astype(np.int64)

    # piece -> contig (pieces with depth>=1 never span contigs: they
    # lie inside read intervals, which are clamped per contig)
    t = np.searchsorted(lay.offsets, a, side="right") - 1
    g0 = lay.offsets[t]
    ge = g0 + counts[t].astype(np.int64) * w
    b = np.minimum(b, ge)
    ok = b > a
    a, b, d, t, g0 = a[ok], b[ok], d[ok], t[ok], g0[ok]

    jal = (a - g0) // w          # window index local to the contig
    jbl = (b - 1 - g0) // w
    ja = jal + woff[t]
    jb = jbl + woff[t]
    multi = (jb > ja).astype(np.float64)
    # uniform per-piece decomposition (no class masks): the head cell
    # clips to the piece end for single-window pieces, the tail and
    # interior weights are zeroed by `multi`, and zero-weight bincount
    # entries are free. float64 accumulation is exact here (addends
    # < 2^26 with 18-bit depths, running sums far below 2^53);
    # np.bincount would also silently return int64 if a weights array
    # were empty.
    head = np.minimum(b, g0 + (jal + 1) * w) - a
    tail = (b - (g0 + jbl * w)) * multi
    pt_idx = np.concatenate([ja, jb])
    cover_pt = np.bincount(pt_idx,
                           weights=np.concatenate([head, tail]),
                           minlength=W + 1).astype(np.float64,
                                                   copy=False)
    dsum_pt = np.bincount(pt_idx,
                          weights=np.concatenate([head * d, tail * d]),
                          minlength=W + 1)
    # full interior windows (ja+1 .. jb-1): diff array + cumsum
    wm = w * multi
    edges = np.concatenate([ja + 1, jb])
    cover_in = np.cumsum(np.bincount(
        edges, weights=np.concatenate([wm, -wm]),
        minlength=W + 2))
    dsum_in = np.cumsum(np.bincount(
        edges, weights=np.concatenate([wm * d, -wm * d]),
        minlength=W + 2))
    cover = (cover_pt[:W] + cover_in[:W]).astype(np.int64)
    dsum = (dsum_pt[:W] + dsum_in[:W]).astype(np.int64)

    # clipped final windows: the grid over-counts [L, K*win)
    clip_t = np.nonzero(used & (exp_counts * w > lay.lengths))[0]
    if clip_t.shape[0]:
        # the grid tail [L, K*w) can extend past the contig's slack
        # (K*w - L up to w-1 > pad for large -w) into the NEXT
        # contig's range (limits[t] == offsets[t+1]). The grid only
        # ever counted pieces clipped to this contig (events clamp to
        # the limit), so the over-count to subtract is the integral
        # over [L, K*w) INTERSECTED with the contig range — computed
        # from the covered pieces already in hand (a, b, d, t), NOT
        # from global prefix integrals: this keeps the whole grid
        # path integral-free so mode-6 streaming never derives the
        # O(events) c_cov/c_sum arrays (the -w 100 RSS).
        xlo = lay.offsets[clip_t] + lay.lengths[clip_t]
        xhi = np.minimum(lay.offsets[clip_t] + exp_counts[clip_t] * w,
                         lay.limits[clip_t])
        last_w = woff[clip_t + 1] - 1
        for i, ct in enumerate(clip_t):
            m = t == ct
            ov = np.clip(np.minimum(b[m], xhi[i])
                         - np.maximum(a[m], xlo[i]), 0, None)
            cover[last_w[i]] -= int(ov.sum())
            dsum[last_w[i]] -= int((ov * d[m]).sum())
    return SegmentStats(cover=cover, depth_sum=dsum)


_SLAB_W = 1 << 31  # slab width: local coords stay far below the
#                    u32 sentinel, so no valid position collides


def _finalize_events_slabbed(chunks, extra_pos, extra_delta, sentinel,
                             lo, hi, min_dep, wrap18, keep_state):
    """int64-tier native finalize (> 4 Gb padded genomes, the wheat-
    scale pangenome case): partition events into 2 Gb coordinate
    slabs, run the 32-bit native radix kernel per slab, and chain the
    integrals across slabs with a carried (depth, Q_cov, Q_sum) — the
    same carry algebra as the deep-coverage streaming fold. Returns
    None when the native library is unavailable (callers fall through
    to the numpy twin)."""
    from pandepth_jax.io.native import host_finalize, load_library

    if load_library() is None:
        return None
    u32sent = (1 << 32) - 1
    # valid events as (int64 pos, delta) pieces; const-delta pieces
    # carry a scalar so start/end arrays are never copied here
    pieces: List[Tuple[np.ndarray, object]] = []
    max_needed = 0
    for s, e in chunks:
        vs = s[s < sentinel]
        ve = e[e < sentinel]
        if vs.shape[0]:
            pieces.append((vs, 1))
            max_needed = max(max_needed, int(ve.max()))
        elif ve.shape[0]:
            max_needed = max(max_needed, int(ve.max()))
        if ve.shape[0]:
            pieces.append((ve, -1))
    if extra_pos is not None:
        xv = extra_pos < sentinel
        xp = extra_pos[xv]
        if xp.shape[0]:
            pieces.append((xp, np.asarray(extra_delta)[xv]
                           .astype(np.int32, copy=False)))
            max_needed = max(max_needed, int(xp.max()))
    lo = np.ascontiguousarray(lo, np.int64)
    hi = np.ascontiguousarray(hi, np.int64)
    bx = np.concatenate([lo, hi])
    if bx.shape[0]:
        max_needed = max(max_needed, int(bx.max()))
    n_slabs = max_needed // _SLAB_W + 1
    b_slab = bx // _SLAB_W
    q_val = np.zeros((2, bx.shape[0]), np.int64)  # Q_cov, Q_sum per b
    chain_cov = chain_sum = 0
    carry_depth = 0
    state_pos: List[np.ndarray] = []
    state_dep: List[np.ndarray] = []
    for sl in range(n_slabs):
        base = sl * _SLAB_W
        xs: List[np.ndarray] = []
        xd: List[np.ndarray] = []
        for p, d in pieces:
            m = (p >= base) & (p < base + _SLAB_W)
            k = int(m.sum())
            if not k:
                continue
            xs.append((p[m] - base).astype(np.uint32))
            xd.append(np.full(k, d, np.int32) if np.isscalar(d)
                      else d[m])
        bsel = np.nonzero(b_slab == sl)[0]
        carry_disp = (carry_depth & WRAP18_MASK) if wrap18 \
            else carry_depth
        ind = 1 if carry_disp >= min_dep else 0
        if not xs:
            # empty slab: the chain advances analytically under the
            # constant carried depth
            if bsel.shape[0]:
                bl = bx[bsel] - base
                q_val[0, bsel] = chain_cov + bl * ind
                q_val[1, bsel] = chain_sum + bl * ind * carry_disp
            chain_cov += _SLAB_W * ind
            chain_sum += _SLAB_W * ind * carry_disp
            if keep_state and carry_depth and sl:
                state_pos.append(np.asarray([base], np.int64))
                state_dep.append(np.asarray([carry_disp], np.int32))
            continue
        # the carried depth enters as one synthetic +carry event at
        # the slab origin; every boundary in this slab is the query
        # (0, b_local], plus one (0, W) chain query
        xs.append(np.zeros(1, np.uint32))
        xd.append(np.asarray([carry_disp], np.int32))
        xpos = np.concatenate(xs)
        xdel = np.concatenate(xd)
        nq = bsel.shape[0]
        qlo = np.zeros(nq + 1, np.int64)
        qhi = np.empty(nq + 1, np.int64)
        qhi[:nq] = bx[bsel] - base
        qhi[nq] = _SLAB_W
        res = host_finalize([], u32sent, xpos, xdel, qlo, qhi,
                            min_dep, wrap18, keep_state=keep_state)
        if res is None:
            return None
        cov, dsm, st = res
        if nq:
            q_val[0, bsel] = chain_cov + cov[:nq]
            q_val[1, bsel] = chain_sum + dsm[:nq]
        chain_cov += int(cov[nq])
        chain_sum += int(dsm[nq])
        carry_depth += int(xdel.sum()) - carry_disp
        if keep_state:
            state_pos.append(st[0] + base)
            state_dep.append(st[1])
    cover = q_val[0, lo.shape[0]:] - q_val[0, :lo.shape[0]]
    dsum = q_val[1, lo.shape[0]:] - q_val[1, :lo.shape[0]]
    state = None
    if keep_state:
        state = (np.concatenate(state_pos) if state_pos
                 else np.zeros(0, np.int64),
                 np.concatenate(state_dep) if state_dep
                 else np.zeros(0, np.int32))
    return cover, dsum, state


def finalize_events(chunks: List[Tuple[np.ndarray, np.ndarray]],
                    extra_pos: Optional[np.ndarray],
                    extra_delta: Optional[np.ndarray],
                    sentinel: int, lo: np.ndarray, hi: np.ndarray,
                    min_dep: int, wrap18: bool, keep_state: bool):
    """Sort + sweep + eval over host-resident event feeds.

    ``chunks``: (starts, ends) pairs (sentinel-slot padded, engine
    pos_dtype); ``extra``: optional pre-built (pos, delta). Native
    libpancov_io (parallel radix sort + one sweep,
    pancov_host_finalize) with a numpy twin as fallback; int64-tier
    feeds (> 4 Gb padded genomes) keep the native kernel via 2 Gb
    coordinate slabs (:func:`_finalize_events_slabbed`). Returns
    (cover, dsum, state) — state = (pos_s int64, depth int32) sorted
    breakpoints when ``keep_state`` else None."""
    try:
        from pandepth_jax.io.native import host_finalize

        res = host_finalize(list(chunks), sentinel, extra_pos,
                            extra_delta, lo, hi, min_dep, wrap18,
                            keep_state=keep_state)
    except Exception:
        res = None
    if res is None and os.environ.get("PANDEPTH_SLAB64", "1") != "0":
        try:
            res = _finalize_events_slabbed(
                chunks, extra_pos, extra_delta, sentinel, lo, hi,
                min_dep, wrap18, keep_state)
        except Exception:
            res = None
    if res is not None:
        return res

    # numpy twin (no native library): argsort + cumsum
    pos = [np.asarray(s, np.int64) for s, _ in chunks] + \
        [np.asarray(e, np.int64) for _, e in chunks]
    dlt = [np.where(np.asarray(s, np.int64) == sentinel, 0, 1)
           for s, _ in chunks] + \
        [np.where(np.asarray(e, np.int64) == sentinel, 0, -1)
         for _, e in chunks]
    if extra_pos is not None:
        pos.append(np.asarray(extra_pos, np.int64))
        dlt.append(np.where(np.asarray(extra_pos, np.int64) ==
                            sentinel, 0, extra_delta))
    p = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    d = (np.concatenate(dlt).astype(np.int32) if dlt
         else np.zeros(0, np.int32))
    order = np.argsort(p, kind="stable")
    p, d = p[order], d[order]
    depth = np.cumsum(d, dtype=np.int64)
    if wrap18:
        depth = depth & WRAP18_MASK
    depth = depth.astype(np.int32)
    live = p < sentinel
    p, depth = p[live], depth[live]
    sweep = derive_integrals(p, depth, min_dep)
    qc_lo, qs_lo = host_q_eval(sweep, min_dep, lo,
                               np.searchsorted(p, lo, side="left"))
    qc_hi, qs_hi = host_q_eval(sweep, min_dep, hi,
                               np.searchsorted(p, hi, side="left"))
    state = (p, depth) if keep_state else None
    return qc_hi - qc_lo, qs_hi - qs_lo, state
