"""Lifted-circulant belief-propagation decoder (IEEE 802.11n, AR4JA).

DVB-S2 has a quasi-cyclic decoder whose permutations lower to cyclic rolls
of (360, B) planes instead of XLA gathers (comm/fec_qc.py). The other two
standard families are *also* lifted-circulant:

- **IEEE 802.11n** (comm/codes.py:109): H is an (mb, 24) base of Z x Z
  circulant-permutation blocks (Z = n/24 in {27, 54, 81}); every edge
  bundle between check block-row rb and variable block-column cb is a
  cyclic roll by the base shift of one (Z, B) plane.
- **AR4JA** (comm/codes.py:129): each M x M base block is a GF(2) sum of
  permutations ``pi(i) = Q*tq[i//Q] + (off[i//Q] + i) % Q`` (Q = M/4) —
  i.e. splitting every block row/column into its 4 quarter-planes of Q
  rows, every edge bundle is a cyclic roll of a (Q, B) plane.

This module generalizes the fec_qc construction to any such lift: planes
of L rows, a static edge list (check plane, variable plane, shift), check
and variable sides bucketed by (uniform-within-plane) degree, all
permutations as static slice+concat rolls. Semantics (flooding schedule,
freeze-on-convergence, min-sum/SPA/NMSA kernels, message dtype) match
:func:`fec._bp_decode_bucketed`; reference decode behavior cited there
(/root/reference/optic/comm/fec.py:505,:684 — one decode path for all 38
shipped codes).
"""

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from . import _code_tables
from .codes import _rate_tag
from .fec_qc import _check_msa_slots, _check_spa_slots


def _edges_80211(n, R):
    data = _code_tables.IEEE80211[f"{n}_{_rate_tag(R)}"]
    shifts = np.asarray(data["shifts"], dtype=np.int64)
    Z = n // 24
    mb = shifts.shape[0]
    edges = []
    for rb, cb in zip(*np.nonzero(shifts >= 0)):
        s = int(shifts[rb, cb])
        # check row i meets variable (i + s) % Z: check-aligned totals are
        # roll(T, -s); back-roll to variable alignment is +s
        edges.append((int(rb), int(cb), (-s) % Z, s % Z))
    return Z, 24, mb, edges


def _edges_ar4ja(n, R):
    data = _code_tables.AR4JA[f"{n}_{_rate_tag(R)}"]
    M, nb = data["M"], data["nb"]
    mb = data["m"] // M
    Q = M // 4
    edges = []
    for key2, perms in data["blocks"].items():
        rb, cb = (int(v) for v in key2.split(","))
        for p in perms:
            for j in range(4):
                tq, off = int(p[j][0]), int(p[j][1])
                edges.append((rb * 4 + j, cb * 4 + tq, (-off) % Q, off % Q))
    # GF(2) cancellation of duplicate (check, var, shift) triples — the
    # extraction guarantees none survive, but stay consistent with
    # codes.ar4ja_edges if tables are ever hand-extended
    from collections import Counter

    cnt = Counter(edges)
    edges = [e for e, c in cnt.items() if c % 2 == 1]
    return Q, nb * 4, mb * 4, edges


@lru_cache(maxsize=None)
def lift_tables(mode, n, R):
    """Static plane/edge addressing for one lifted-circulant code.

    Returns plain numpy/python structures (trace-time only):
    - ``L, V, C``: lift size, #variable planes, #check planes.
    - ``chk_buckets``: ((d, ng), ...) check planes by degree; per bucket
      ``ev/esh`` (d, ng): variable plane (bucket-order position) and
      T-roll per edge slot. Edge ids are bucket-major, slot-major:
      ``eid = off + sl * ng + ig`` — so each bucket's message block
      reshapes to (d, ng, L, B) with zero copies.
    - ``var_buckets``: ((dv, ngv), ...); per bucket ``ve/vsh`` (dv, ngv):
      edge id and back-roll per variable-plane entry.
    - ``var_order/pos_of_v``: natural plane id <-> bucket-order position.
    """
    if mode == "IEEE_802.11nD2":
        L, V, C, edges = _edges_80211(n, R)
    elif mode == "AR4JA":
        L, V, C, edges = _edges_ar4ja(n, R)
    else:
        raise ValueError(f"no lift construction for mode {mode!r}")

    by_chk = [[] for _ in range(C)]
    for c, v, tsh, bsh in edges:
        by_chk[c].append((v, tsh, bsh))
    for lst in by_chk:
        lst.sort()
    cdeg = np.array([len(lst) for lst in by_chk])
    if (cdeg == 0).any():
        raise ValueError("check plane with no edges")
    chk_order = np.lexsort((np.arange(C), cdeg))

    # variable-plane bucket order (positions used by the check-side tables)
    vdeg_nat = np.zeros(V, np.int64)
    for c, v, tsh, bsh in edges:
        vdeg_nat[v] += 1
    var_order = np.lexsort((np.arange(V), vdeg_nat)).astype(np.int32)
    pos_of_v = np.empty(V, np.int32)
    pos_of_v[var_order] = np.arange(V, dtype=np.int32)

    chk_buckets, ev_tabs, esh_tabs, bsh_tabs, chk_planes = [], [], [], [], []
    by_var = [[] for _ in range(V)]  # (eid, back_shift) per variable plane
    off = 0
    for d in np.unique(cdeg):
        cs = chk_order[cdeg[chk_order] == d]
        ng = int(cs.size)
        chk_buckets.append((int(d), ng))
        ev = np.empty((int(d), ng), np.int32)
        esh = np.empty((int(d), ng), np.int32)
        bsh = np.empty((int(d), ng), np.int32)
        for ig, c in enumerate(cs):
            for sl, (v, tsh, bs) in enumerate(by_chk[c]):
                ev[sl, ig] = pos_of_v[v]
                esh[sl, ig] = tsh
                bsh[sl, ig] = bs
                by_var[v].append((off + sl * ng + ig, bs))
        ev_tabs.append(ev)
        esh_tabs.append(esh)
        bsh_tabs.append(bsh)
        chk_planes.append(cs.astype(np.int32))
        off += int(d) * ng

    vdeg = vdeg_nat
    var_buckets, ve_tabs, vsh_tabs = [], [], []
    for dv in np.unique(vdeg):
        vs = var_order[vdeg[var_order] == dv]
        ngv = int(vs.size)
        var_buckets.append((int(dv), ngv))
        ve = np.empty((int(dv), ngv), np.int32)
        vsh = np.empty((int(dv), ngv), np.int32)
        for ig, v in enumerate(vs):
            for sl, (eid, bs) in enumerate(by_var[v]):
                ve[sl, ig] = eid
                vsh[sl, ig] = bs
        ve_tabs.append(ve)
        vsh_tabs.append(vsh)

    return {
        "L": L, "V": V, "C": C, "E": off,
        "chk_buckets": tuple(chk_buckets), "ev": ev_tabs, "esh": esh_tabs,
        "var_buckets": tuple(var_buckets), "ve": ve_tabs, "vsh": vsh_tabs,
        "var_order": var_order, "pos_of_v": pos_of_v,
    }


def _roll(p, sh, L):
    sh = int(sh) % L
    if sh == 0:
        return p
    return jnp.concatenate([p[-sh:], p[:-sh]], axis=0)


@lru_cache(maxsize=None)
def make_lift_decoder(mode, n, R, max_iter, alg="MSA", msg_dtype="f32",
                      early_exit=False):
    """Jitted ``decode(llrs (n_cols, B) f32) -> (out_llr, n_iters, fail)``.

    Same contract and semantics as :func:`fec_qc.make_qc_decoder`; the
    code structure (which is all static) comes from :func:`lift_tables`.
    ``early_exit`` runs the iteration as a while_loop that stops once the
    whole batch has converged (identical outputs either way).
    """
    tb = lift_tables(mode, n, R)
    L, V = tb["L"], tb["V"]
    mdt = jnp.bfloat16 if msg_dtype == "bf16" else jnp.float32
    if alg == "SPA":
        check_update = _check_spa_slots
    elif alg == "NMSA":
        def check_update(x):
            return (0.75 * _check_msa_slots(x).astype(jnp.float32)).astype(
                x.dtype)
    else:
        check_update = _check_msa_slots
    # numpy (not jnp): the builder may run under an outer jit trace, where
    # jnp.asarray binds tracer constants that leak through lru_cache
    var_order = tb["var_order"]
    pos_back = tb["pos_of_v"]

    def v2c(T):
        """Check-aligned totals per bucket: list of (d, ng, L, B) mdt."""
        out = []
        for (d, ng), ev, esh in zip(tb["chk_buckets"], tb["ev"], tb["esh"]):
            planes = [
                _roll(T[ev[sl, ig]], esh[sl, ig], L)
                for sl in range(d) for ig in range(ng)
            ]
            out.append(jnp.stack(planes).reshape(
                d, ng, L, -1).astype(mdt))
        return out

    def c2v_sum(M_flat, llr_bo):
        """Bucket-order new totals T (Vo, L, B) f32 from flat messages."""
        sums = []
        for (dv, ngv), ve, vsh in zip(
                tb["var_buckets"], tb["ve"], tb["vsh"]):
            planes = [
                _roll(M_flat[ve[sl, ig]], vsh[sl, ig], L)
                for sl in range(dv) for ig in range(ngv)
            ]
            stacked = jnp.stack(planes).reshape(
                dv, ngv, *planes[0].shape)
            sums.append(jnp.sum(stacked, axis=0, dtype=jnp.float32))
        return llr_bo + jnp.concatenate(sums)

    @jax.jit
    def decode(llrs):
        B = llrs.shape[1]
        llr_bo = llrs.reshape(V, L, B)[var_order]

        X0 = v2c(llr_bo)
        carry0 = (tuple(X0), jnp.zeros(B, bool), llr_bo,
                  jnp.zeros(B, jnp.int32))

        def iteration(carry, _):
            Xb, done, fT, n_iters = carry
            Ms = [check_update(x) for x in Xb]
            M_flat = jnp.concatenate(
                [m.reshape(-1, L, B) for m in Ms])
            T = c2v_sum(M_flat, llr_bo)
            tot = v2c(T)
            Xn = tuple(t - m for t, m in zip(tot, Ms))
            ok = jnp.ones(B, bool)
            for t in tot:
                par = jnp.sum((t < 0).astype(jnp.int8), axis=0) & 1
                ok = ok & jnp.all(par == 0, axis=(0, 1))
            fT = jnp.where(done[None, None, :], fT, T)
            n_iters = jnp.where(done, n_iters, n_iters + 1)
            done = done | ok
            return (Xn, done, fT, n_iters), None

        if early_exit:
            def cond(state):
                it, carry = state
                return (it < max_iter) & ~jnp.all(carry[1])

            def w_body(state):
                it, carry = state
                return it + 1, iteration(carry, None)[0]

            _, (_, done, fT, n_iters) = jax.lax.while_loop(
                cond, w_body, (jnp.asarray(0), carry0))
        else:
            (_, done, fT, n_iters), _ = jax.lax.scan(
                iteration, carry0, None, length=max_iter)
        out = fT[pos_back].reshape(V * L, B)
        return out, n_iters, ~done

    return decode
