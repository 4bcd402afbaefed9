"""Quasi-cyclic belief-propagation decoder for DVB-S2 LDPC codes.

Why this exists: the general decoder (:mod:`fec`) moves every message
through XLA gathers. The ETSI EN 302 307-1 construction is quasi-cyclic: info bit
``i = 360 g + t`` meets checks ``(x + t q) mod m``, i.e. writing checks as a
``(Z=360, q)`` plane (``c = q s + a0``), every info edge bundle is a *cyclic
roll by x//q along the Z axis* of one 360-row plane, and the accumulator
staircase is a one-position shift in flat check order. Rolls lower to static
slice+concat pairs — pure streaming copies that XLA fuses into the
neighbouring elementwise passes — so no message moves through a gather.

Message layout: ``X[(S+2), q, Z, B]`` — V->C messages in *check alignment*
(row s of plane ``(sl, a0)`` belongs to check ``c = q s + a0``). Slots
``0..S-1`` hold the uniform per-column info entries (S = entries per check
column, constant per code by construction — verified for all 11 shipped
rates), slot ``S`` the accumulator self edge ``p_j -> c_j``, slot ``S+1``
the staircase edge ``p_{j-1} -> c_j`` (masked at ``j = 0``: check 0 has
degree dc-1, reference ALIST row 1).

Semantics match :func:`fec._bp_decode_bucketed` (flooding schedule,
freeze-on-convergence early exit, same check kernels) — only the message
*layout* differs; reference behavior cited there
(/root/reference/optic/comm/fec.py:505-561). One deliberate delta at
``msgDtype='bf16'``: here the v2c subtraction ``Xn = tot - M`` runs in the
bf16 storage dtype (``tot`` is cast at stack time so the large stacked
tensor is never materialized in f32), while ``_bp_decode_bucketed``
subtracts in f32 and casts the result — the two paths round at different
points, so bf16 messages differ in the last bf16 ulp between layouts
(equal BER in the waterfall tests; f32 is bit-identical).
"""

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from . import _code_tables
from .codes import _rate_tag

Z = 360  # ETSI EN 302 307-1 group size


def qc_tables(R="4/5", n=64800):
    """Static QC addressing tables for one DVB-S2 code.

    Returns a dict of plain numpy arrays / python ints (consumed at trace
    time; nothing here touches the device):

    - ``g_tab, s_tab`` (q, S): per check column ``a0``, the info group and
      roll amount ``x1 = x // q`` of each of its S entries.
    - ``buckets``: tuple of ``(deg, n_groups)`` variable-degree buckets.
    - ``order_rows`` (G,): group ids in bucket order (degree-major).
    - ``pos_of_g`` (G,): position of canonical group g in bucket order.
    - ``ent_addr``: per bucket, (n_groups, deg, 3) int array of each group
      entry's (a0, slot, shift) address.
    """
    data = _code_tables.DVBS2[f"{n}_{_rate_tag(R)}"]
    k = data["k"]
    m = n - k
    q = m // Z
    G = k // Z
    cols = [[] for _ in range(q)]
    for g, row in enumerate(data["table"]):
        for x in row:
            cols[x % q].append((g, x // q))
    S = len(cols[0])
    if any(len(c) != S for c in cols):  # pragma: no cover - none shipped
        raise ValueError("non-uniform check-column degrees; use fec decoder")
    g_tab = np.array([[e[0] for e in c] for c in cols], np.int32)
    s_tab = np.array([[e[1] for e in c] for c in cols], np.int32)
    # entry addresses per group: (a0, slot, shift)
    ent = [[] for _ in range(G)]
    for a0 in range(q):
        for sl in range(S):
            ent[g_tab[a0, sl]].append((a0, sl, s_tab[a0, sl]))
    gdeg = np.array([len(e) for e in ent], np.int64)
    order_rows = np.lexsort((np.arange(G), gdeg)).astype(np.int32)
    pos_of_g = np.empty(G, np.int32)
    pos_of_g[order_rows] = np.arange(G, dtype=np.int32)
    buckets, ent_addr = [], []
    start = 0
    for d in np.unique(gdeg):
        gs = order_rows[gdeg[order_rows] == d]
        buckets.append((int(d), int(gs.size)))
        ent_addr.append(
            np.array([ent[g] for g in gs], np.int32).reshape(gs.size, int(d), 3)
        )
        start += gs.size
    return {
        "n": n, "k": k, "m": m, "q": q, "G": G, "S": S,
        "g_tab": g_tab, "s_tab": s_tab,
        "buckets": tuple(buckets), "ent_addr": ent_addr,
        "order_rows": order_rows, "pos_of_g": pos_of_g,
    }


def _roll(p, sh):
    """Static cyclic roll of a (Z, B) plane along axis 0 (slice+concat)."""
    sh = int(sh) % Z
    if sh == 0:
        return p
    return jnp.concatenate([p[-sh:], p[:-sh]], axis=0)


def _check_msa_slots(x):
    """Min-sum leave-one-out along axis 0 of (D, ...), dtype-preserving.

    Exact exclusive-min via prefix/suffix min chains over the D slabs:
    ``out_mag[i] = min(mag[:i], mag[i+1:])`` — elementwise chains over a
    static slot axis, which XLA fuses (no argmin, no cumsum).
    min/sign are exact in bf16, so the whole update runs in the message
    storage dtype. +inf inputs are neutral (masked j=0 staircase slot).
    """
    D = x.shape[0]
    mag = jnp.abs(x)
    inf = jnp.full_like(mag[:1], jnp.inf)
    fe = [inf]  # fe[i] = min(mag[:i])
    for i in range(1, D):
        fe.append(jnp.minimum(fe[-1], mag[i - 1:i]))
    be = [inf]  # be[i] = min(mag[i+1:]), built backwards
    for i in range(D - 1, 0, -1):
        be.append(jnp.minimum(be[-1], mag[i:i + 1]))
    be.reverse()
    out_mag = jnp.concatenate(
        [jnp.minimum(f, b) for f, b in zip(fe, be)], axis=0)
    neg = x < 0
    par = jnp.sum(neg, axis=0, keepdims=True, dtype=jnp.int8) & 1
    flip = jnp.where(neg, 1 - par, par)  # parity of the OTHER slots' signs
    return jnp.where(flip == 1, -out_mag, out_mag)


def _check_spa_slots(x):
    """SPA leave-one-out along axis 0 of (D, ...): exclusive tanh products.

    Same prefix/suffix slab chains as the MSA kernel (f32 math, cast back
    to the input dtype)."""
    dt = x.dtype
    D = x.shape[0]
    t = jnp.tanh(x.astype(jnp.float32) / 2.0)
    one = jnp.ones_like(t[:1])
    fe = [one]
    for i in range(1, D):
        fe.append(fe[-1] * t[i - 1:i])
    be = [one]
    for i in range(D - 1, 0, -1):
        be.append(be[-1] * t[i:i + 1])
    be.reverse()
    prod = jnp.concatenate([f * b for f, b in zip(fe, be)], axis=0)
    prod = jnp.clip(prod, -0.999999, 0.999999)
    return (2.0 * jnp.arctanh(prod)).astype(dt)


@lru_cache(maxsize=None)
def make_qc_decoder(n, R, max_iter, alg="MSA", msg_dtype="f32",
                    early_exit=False):
    """Build a jitted ``decode(llrs (n,B) f32) -> (out_llr, n_iters, fail)``.

    All graph structure is baked in as static python; the compiled program
    contains only rolls, reshapes and dense slot math. ``msg_dtype`` is the
    storage dtype of the message carry (math always f32), as in
    :func:`fec._bp_decode_bucketed`.

    ``early_exit=True`` stops iterating once the whole batch has converged
    (a ``while_loop``) — identical outputs (per-codeword results are frozen
    at their own convergence either way), but wall time tracks the slowest
    codeword instead of ``max_iter`` (the reference decoder's default
    serving behavior, fec.py:494-497). Keep False when benchmarking
    fixed-iteration throughput. The schedule is flooding, as in the
    reference.
    """
    tb = qc_tables(R, n)
    k, m, q, G, S = tb["k"], tb["m"], tb["q"], tb["G"], tb["S"]
    g_tab, s_tab = tb["g_tab"], tb["s_tab"]
    pos_of_g = tb["pos_of_g"]
    order_rows = tb["order_rows"]  # numpy: builders may run under a trace
    if alg == "SPA":
        check_update = _check_spa_slots
    elif alg == "NMSA":
        # normalized min-sum (alpha=0.75, exact in bf16; see fec._NMSA_ALPHA)
        def check_update(x):
            return (0.75 * _check_msa_slots(x).astype(jnp.float32)).astype(
                x.dtype)
    else:
        check_update = _check_msa_slots
    mdt = jnp.bfloat16 if msg_dtype == "bf16" else jnp.float32

    def v2c_totals(T, Tp):
        """Stack per-edge totals (S+2, q, Z, B) from bucket-order T/Tp.

        Cast to the message dtype at stack time so the 119 MB (R4/5, B=128)
        stacked tensor is stored at message precision."""
        slots = []
        for sl in range(S):
            slots.append(jnp.stack([
                _roll(T[pos_of_g[g_tab[a0, sl]]], s_tab[a0, sl])
                for a0 in range(q)
            ]).astype(mdt))
        # staircase: slot S = p_j at check j; slot S+1 = p_{j-1} at check j
        shiftfwd = jnp.concatenate(
            [jnp.roll(Tp[-1:], 1, axis=1), Tp[:-1]], axis=0)
        return jnp.stack(slots + [Tp.astype(mdt), shiftfwd.astype(mdt)])

    def c2v_info_sum(M):
        """Bucket-order (G, Z, B) sums of check messages rolled back.

        Messages stay in their storage dtype; the per-variable sums
        accumulate in f32."""
        planes, out, off = [], [], 0
        for bi, (d, ng) in enumerate(tb["buckets"]):
            addr = tb["ent_addr"][bi].reshape(ng * d, 3)
            planes.extend(
                _roll(M[sl, a0], -sh) for a0, sl, sh in addr.tolist())
        stacked = jnp.stack(planes)
        for d, ng in tb["buckets"]:
            cnt = ng * d
            out.append(jnp.sum(
                stacked[off:off + cnt].reshape(ng, d, *stacked.shape[1:]),
                axis=1, dtype=jnp.float32))
            off += cnt
        return jnp.concatenate(out)

    @jax.jit
    def decode(llrs):
        B = llrs.shape[1]
        llr_info = llrs[:k].reshape(G, Z, B)[order_rows]  # bucket order
        llr_p = llrs[k:].reshape(Z, q, B).transpose(1, 0, 2)  # (q, Z, B)

        X0 = v2c_totals(llr_info, llr_p)
        # done/n_iters derived from the data, not jnp.zeros: under
        # shard_map the scan carry must be device-varying from iteration 0
        # (same rule as _manakov_span's while_loop carries)
        carry0 = (X0, llrs[0] != llrs[0], llr_info, llr_p,
                  (llrs[0] * 0).astype(jnp.int32))

        def iteration(carry, _):
            X, done, fT, fTp, n_iters = carry
            Xm = X.at[S + 1, 0, 0].set(jnp.inf)  # no p_{-1} at check 0
            with jax.named_scope("ldpc_check"):  # profiler attribution
                M = check_update(Xm)  # dtype-preserving
            T = llr_info + c2v_info_sum(M)
            Mp = M[S + 1].astype(jnp.float32).at[0, 0].set(0.0)
            shiftback = jnp.concatenate(
                [Mp[1:], jnp.roll(Mp[:1], -1, axis=1)], axis=0)
            Tp = llr_p + M[S].astype(jnp.float32) + shiftback
            tot_e = v2c_totals(T, Tp)
            Xn = tot_e - M
            bits = (tot_e < 0).astype(jnp.int8)
            bits = bits.at[S + 1, 0, 0].set(0)
            ok = jnp.all(
                jnp.sum(bits, axis=0, dtype=jnp.int8) % 2 == 0, axis=(0, 1))
            fT = jnp.where(done, fT, T)
            fTp = jnp.where(done, fTp, Tp)
            # X itself is deliberately NOT frozen: every observable output
            # (fT, fTp, n_iters, fail) is frozen above and ``done``
            # latches, so letting a converged codeword's messages keep
            # updating is unobservable — and skipping the select saves a
            # full re-read of the old message tensor each iteration.
            n_iters = jnp.where(done, n_iters, n_iters + 1)
            done = done | ok
            return (Xn, done, fT, fTp, n_iters), None

        if early_exit:
            def cond(state):
                it, carry = state
                return (it < max_iter) & ~jnp.all(carry[1])

            def w_body(state):
                it, carry = state
                return it + 1, iteration(carry, None)[0]

            _, (_, done, fT, fTp, n_iters) = jax.lax.while_loop(
                cond, w_body, (jnp.asarray(0), carry0))
        else:
            (_, done, fT, fTp, n_iters), _ = jax.lax.scan(
                iteration, carry0, None, length=max_iter)
        out_info = fT[jnp.asarray(pos_of_g)].reshape(G * Z, B)
        out_p = fTp.transpose(1, 0, 2).reshape(m, B)
        return jnp.concatenate([out_info, out_p]), n_iters, ~done

    return decode
